"""ctypes-bound CUDA kernels with their plain torch dispatch."""
