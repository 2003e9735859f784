// Reverse Cuthill-McKee ordering of a CSR graph, the host ordering of the
// banded preconditioner (vasp_tpu_torch/fem/banded.py).
//
// The same algorithm, line for line, as vasp_tpu/native/meshcore.cpp
// rcm_order: the neighbours of each visited node are sorted by degree with
// std::sort, which is not stable, so only this C++ reproduces vasp_tpu's
// permutation (and with it the block size c, the block count nb and every
// factor). Built with g++ into build/vasp_tpu_torch/ at first use
// (vasp_tpu_torch/native/__init__.py).
#include <algorithm>
#include <cstdint>
#include <queue>
#include <vector>

extern "C" {

// indptr (n+1,), indices (nnz,) int64; perm_out (n,).
void vt_rcm_order(const int64_t* indptr, const int64_t* indices, int64_t n,
                  int64_t* perm_out) {
  std::vector<int64_t> degree(n);
  for (int64_t i = 0; i < n; ++i) degree[i] = indptr[i + 1] - indptr[i];
  std::vector<char> visited(n, 0);
  std::vector<int64_t> order;
  order.reserve(n);
  std::vector<int64_t> nbrs;
  for (;;) {
    // next unvisited node of minimum degree
    int64_t start = -1, best = INT64_MAX;
    for (int64_t i = 0; i < n; ++i)
      if (!visited[i] && degree[i] < best) { best = degree[i]; start = i; }
    if (start < 0) break;
    std::queue<int64_t> q;
    q.push(start);
    visited[start] = 1;
    while (!q.empty()) {
      int64_t u = q.front();
      q.pop();
      order.push_back(u);
      nbrs.clear();
      for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
        int64_t w = indices[k];
        if (!visited[w]) { visited[w] = 1; nbrs.push_back(w); }
      }
      std::sort(nbrs.begin(), nbrs.end(),
                [&](int64_t x, int64_t y) { return degree[x] < degree[y]; });
      for (int64_t w : nbrs) q.push(w);
    }
  }
  // reverse
  for (int64_t i = 0; i < n; ++i) perm_out[i] = order[n - 1 - i];
}

}  // extern "C"
