"""Simulation-log parsing and plotting (the offline trace viewer).

Counterpart of vasp_tpu.postprocessing.log_plotter (host code, copied;
matplotlib is imported at first use).
Parity target: vasp-log-plotter
(reference: src/vasp/postprocessing/log_plotter.py): regex-parses the solver
stdout (time step/CPU time/ramp factor/interface pressure/Newton residuals/
probe velocity+pressure+displacement/flow rate/velocity-CFL-Re triples/min
Jacobian), plots each quantity vs time, per-cycle comparison and
cycle-averaged variants, probe-point TKE via phase-averaged fluctuations,
and saves probe-data pickles. Output PNG names match the reference's
(reference: tests/test_log_plotter.py image lists)."""
import argparse
import json
import pickle
import re
from pathlib import Path

import numpy as np


def _pyplot():
    """matplotlib.pyplot on the Agg backend, imported at first use."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# the exact patterns of reference log_plotter.py:72-84
_PATTERNS = {
    "time_step": re.compile(r"Solved for timestep (.*), t = (.*) in (.*) s"),
    "ramp_factor": re.compile(r"ramp_factor = (.*) m\^3/s"),
    "pressure": re.compile(
        r"Instantaneous normal stress prescribed at the FSI interface (.*) Pa"
    ),
    "newton": re.compile(
        r"Newton iteration (.*): r \(atol\) = (.*) \(tol = .*\), "
        r"r \(rel\) = (.*) \(tol = .*\)"
    ),
    "probe": re.compile(
        r"Probe Point (.*): Velocity: \((.*), (.*), (.*)\) \| Pressure: (.*)"
    ),
    "probe_disp": re.compile(
        r"Probe Point (.*): Displacement: \((.*), (.*), (.*)\)"
    ),
    "flow_rate": re.compile(r"\s*Flow Rate at Inlet: (.*)"),
    "velocity": re.compile(r"\s*Velocity \(mean, min, max\): (.*), (.*), (.*)"),
    "cfl": re.compile(r"\s*CFL \(mean, min, max\): (.*), (.*), (.*)"),
    "reynolds": re.compile(
        r"\s*Reynolds Numbers \(mean, min, max\): (.*), (.*), (.*)"
    ),
    "min_jacobian": re.compile(r"Minimum Jacobian: (.*)"),
}


def parse_log_file(log_file):
    """Parse a solver log into a structured dict of numpy arrays
    (reference: log_plotter.py:30-202)."""
    data = {
        "time_step": [], "time": [], "cpu_time": [], "ramp_factor": [],
        "pressure": [],
        "newton_iteration": {"atol": [], "rtol": []},
        "probe_points": {}, "probe_points_displacement": {},
        "flow_properties": {
            "flow_rate": [], "velocity_mean": [], "velocity_min": [],
            "velocity_max": [], "cfl_mean": [], "cfl_min": [], "cfl_max": [],
            "reynolds_mean": [], "reynolds_min": [], "reynolds_max": [],
        },
        "min_jacobian": [],
    }
    with open(log_file) as f:
        for line in f:
            m = _PATTERNS["time_step"].match(line)
            if m:
                data["time_step"].append(int(m.group(1)))
                data["time"].append(float(m.group(2)))
                data["cpu_time"].append(float(m.group(3)))
                continue
            m = _PATTERNS["ramp_factor"].match(line)
            if m:
                data["ramp_factor"].append(float(m.group(1)))
                continue
            m = _PATTERNS["pressure"].match(line)
            if m:
                data["pressure"].append(float(m.group(1)))
                continue
            m = _PATTERNS["newton"].match(line)
            if m:
                data["newton_iteration"]["atol"].append(float(m.group(2)))
                data["newton_iteration"]["rtol"].append(float(m.group(3)))
                continue
            m = _PATTERNS["probe"].match(line)
            if m:
                p = int(m.group(1))
                d = data["probe_points"].setdefault(
                    p, {"velocity": [], "magnitude": [], "pressure": []}
                )
                vel = [float(m.group(i)) for i in (2, 3, 4)]
                d["velocity"].append(vel)
                d["magnitude"].append(float(np.linalg.norm(vel)))
                d["pressure"].append(float(m.group(5)))
                continue
            m = _PATTERNS["probe_disp"].match(line)
            if m:
                p = int(m.group(1))
                d = data["probe_points_displacement"].setdefault(
                    p, {"displacement": [], "displacement_magnitude": []}
                )
                disp = [float(m.group(i)) for i in (2, 3, 4)]
                d["displacement"].append(disp)
                d["displacement_magnitude"].append(
                    float(np.linalg.norm(disp))
                )
                continue
            for key, field in (
                ("flow_rate", ("flow_rate",)),
                ("velocity", ("velocity_mean", "velocity_min",
                              "velocity_max")),
                ("cfl", ("cfl_mean", "cfl_min", "cfl_max")),
                ("reynolds", ("reynolds_mean", "reynolds_min",
                              "reynolds_max")),
            ):
                m = _PATTERNS[key].match(line)
                if m:
                    for i, name in enumerate(field):
                        data["flow_properties"][name].append(
                            float(m.group(i + 1))
                        )
                    break
            else:
                m = _PATTERNS["min_jacobian"].match(line)
                if m:
                    data["min_jacobian"].append(float(m.group(1)))

    def to_np(d):
        for k, v in d.items():
            if isinstance(v, dict):
                to_np(v)
            elif isinstance(v, list):
                d[k] = np.asarray(v)

    to_np(data)
    return data


def parse_dictionary_from_log(log_file):
    """Extract the default_variables dump from a log, if present
    (reference: log_plotter.py:204-260). Falls back to
    Checkpoint/default_variables.json next to the log."""
    text = Path(log_file).read_text()
    m = re.search(r"\{.*\}", text, re.DOTALL)
    if m:
        try:
            cleaned = m.group(0).replace("'", '"').replace("None", "null") \
                .replace("True", "true").replace("False", "false")
            return json.loads(cleaned)
        except json.JSONDecodeError:
            pass
    cand = Path(log_file).parent / "Checkpoint" / "default_variables.json"
    if cand.exists():
        return json.loads(cand.read_text())
    return {}


def compute_tke_series(probe_velocities, times, period):
    """Full-length TKE series of one probe (reference: log_plotter.py:960-987):
    phase-average the velocity over whole cycles, subtract to get u'(t),
    TKE(t) = 0.5 |u'(t)|^2 — one value per time step."""
    times = np.asarray(times)
    v = np.asarray(probe_velocities)
    if len(times) < 2 or not period:
        return None
    dt = np.mean(np.diff(times))
    spc = int(round(period / dt))
    if spc <= 0:
        return None
    n_cycles = min(len(times), len(v)) // spc
    if n_cycles < 1:
        return None
    vc = v[: n_cycles * spc].reshape(n_cycles, spc, -1)
    phase_mean = vc.mean(axis=0)
    fluct = (vc - phase_mean[None]).reshape(n_cycles * spc, -1)
    return 0.5 * np.sum(fluct ** 2, axis=1)


def compute_tke(probe_velocities, times, period):
    """Turbulent kinetic energy of probe-point velocity via phase-averaged
    fluctuations (reference: log_plotter.py:928-990): split the series into
    cycles, phase-average, subtract, TKE = 0.5 * mean |u'|^2 per phase."""
    times = np.asarray(times)
    if len(times) < 2 or period is None:
        return None, None
    dt = np.mean(np.diff(times))
    steps_per_cycle = int(round(period / dt))
    if steps_per_cycle <= 0:
        return None, None
    n_cycles = len(times) // steps_per_cycle
    if n_cycles < 1:
        return None, None
    v = np.asarray(probe_velocities)[: n_cycles * steps_per_cycle]
    v = v.reshape(n_cycles, steps_per_cycle, -1)
    phase_avg = v.mean(axis=0, keepdims=True)
    fluct = v - phase_avg
    tke = 0.5 * np.sum(fluct ** 2, axis=2).mean(axis=0)
    phase_t = times[:steps_per_cycle]
    return phase_t, tke


# module-level figure size, set from --figure-size (reference
# log_plotter.py:264 threads figure_size through every plot fn)
_FIGSIZE = (10, 6)
# CLI --save semantics (reference log_plotter.py:1145: figures are only
# written when --save is given; otherwise shown): main() flips this off
# for unflagged runs. Library callers (plot_all etc.) save by default.
_SAVE = True


def _emit_fig(path):
    plt = _pyplot()

    if _SAVE:
        plt.savefig(path)
    else:
        plt.show()


def _save_plot(x, ys, labels, title, ylabel, path, xlabel="Time [s]",
               semilogy=False):
    plt = _pyplot()

    fig = plt.figure(figsize=_FIGSIZE)
    plot = plt.semilogy if semilogy else plt.plot
    for y, lab in zip(ys, labels):
        n = min(len(x), len(y))
        if n == 0:
            continue
        plot(x[:n], y[:n], label=lab)
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    plt.title(title)
    if any(labels):
        plt.legend()
    plt.grid(True)
    _emit_fig(path)
    plt.close(fig)


def plot_all(data, out_dir, period=None, save=True, select=None,
             probe_ids=None, save_probes=True):
    """Emit the reference's standard figure set
    (reference image dirs: tests/test_data/reference_images/**).

    select: optional set of figure keys (cpu_time, flow_rate, ...) — when
    given, only those figures are produced (the reference's individual
    --plot-X flags); None plots everything."""
    plt = _pyplot()

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    t = data["time"]
    fp = data["flow_properties"]
    figures = []

    def want(*keys):
        return select is None or any(k in select for k in keys)

    def plot(name, ys, labels, ylabel, x=None, **kw):
        path = out / f"{name}.png"
        _save_plot(t if x is None else x, ys, labels, name.replace("_", " "),
                   ylabel, path, **kw)
        figures.append(path)

    if want("cpu_time"):
        plot("cpu_time", [data["cpu_time"]], [""], "CPU time [s]")
    if len(data["ramp_factor"]) and want("ramp_factor"):
        plot("ramp_factor", [data["ramp_factor"]], [""], "ramp factor")
    if len(data["pressure"]) and want("pressure"):
        plot("pressure", [data["pressure"]], [""], "Pressure [Pa]")
    if want("flow_rate"):
        plot("flow_rate", [fp["flow_rate"]], [""], "Flow rate [m3/s]")
    if want("velocity"):
        plot("velocity",
             [fp["velocity_mean"], fp["velocity_min"], fp["velocity_max"]],
             ["mean", "min", "max"], "Velocity [m/s]")
    if want("cfl"):
        plot("cfl", [fp["cfl_mean"], fp["cfl_min"], fp["cfl_max"]],
             ["mean", "min", "max"], "CFL")
    if want("reynolds"):
        plot("reynolds_numbers",
             [fp["reynolds_mean"], fp["reynolds_min"], fp["reynolds_max"]],
             ["mean", "min", "max"], "Re")
    na = data["newton_iteration"]["atol"]
    nr = data["newton_iteration"]["rtol"]
    if len(na) and want("newton_iteration_atol", "newton_iteration_rtol"):
        xi = np.arange(len(na))
        _save_plot(xi, [na], [""], "newton iteration (atol)", "r (atol)",
                   out / "newton_iteration_(atol).png",
                   xlabel="iteration", semilogy=True)
        _save_plot(xi, [nr], [""], "newton iteration (rtol)", "r (rel)",
                   out / "newton_iteration_(rtol).png",
                   xlabel="iteration", semilogy=True)
        figures += [out / "newton_iteration_(atol).png",
                    out / "newton_iteration_(rtol).png"]
    if len(data["min_jacobian"]) and want("min_jacobian"):
        plot("minimum_jacobian", [data["min_jacobian"]], [""],
             "min J(d)")

    def sel_probes(d):
        items = sorted(d.items())
        if probe_ids is not None:
            items = [(p, v) for p, v in items if p in probe_ids]
        return items

    # probe points
    if data["probe_points"] and want("probe_points", "probe_points_tke"):
        fig = plt.figure(figsize=_FIGSIZE)
        for p, d in sel_probes(data["probe_points"]):
            n = min(len(t), len(d["magnitude"]))
            plt.plot(t[:n], d["magnitude"][:n], label=f"probe {p}")
        plt.xlabel("Time [s]")
        plt.ylabel("|u| [m/s]")
        plt.legend()
        plt.grid(True)
        _emit_fig(out / "probe_points.png")
        plt.close(fig)
        figures.append(out / "probe_points.png")
        # TKE: the full-length series, one value per time step
        # (reference plot_probe_points_tke, log_plotter.py:992-1060)
        if period and want("probe_points_tke"):
            fig = plt.figure(figsize=_FIGSIZE)
            plotted = False
            for p, d in sel_probes(data["probe_points"]):
                tke = compute_tke_series(
                    d["velocity"], t[: len(d["velocity"])], period)
                if tke is not None:
                    plt.plot(t[: len(tke)], tke, label=f"probe {p}")
                    plotted = True
            if plotted:
                plt.xlabel("Time [s]")
                plt.ylabel("TKE [m2/s2]")
                plt.legend()
                plt.grid(True)
                _emit_fig(out / "probe_points_tke.png")
                figures.append(out / "probe_points_tke.png")
            plt.close(fig)
    if data["probe_points_displacement"] and want(
            "probe_points_displacement"):
        fig = plt.figure(figsize=_FIGSIZE)
        for p, d in sel_probes(data["probe_points_displacement"]):
            mag = d["displacement_magnitude"]
            n = min(len(t), len(mag))
            plt.plot(t[:n], mag[:n], label=f"probe {p}")
        plt.xlabel("Time [s]")
        plt.ylabel("|d| [m]")
        plt.legend()
        plt.grid(True)
        _emit_fig(out / "probe_points_displacement.png")
        plt.close(fig)
        figures.append(out / "probe_points_displacement.png")

    # probe data pickles, velocity AND displacement
    # (reference: log_plotter.py:717-807)
    if save_probes:
        with open(out / "probe_points.pickle", "wb") as f:
            pickle.dump(data["probe_points"], f)
        if data["probe_points_displacement"]:
            with open(out / "probe_points_displacement.pickle", "wb") as f:
                pickle.dump(data["probe_points_displacement"], f)
    return figures


def trim_cycles(data, period, start_cycle=1, end_cycle=None):
    """Restrict every time-aligned series to cycles [start_cycle, end_cycle]
    (1-based, inclusive; reference: --start-cycle/--end-cycle semantics)."""
    t = data["time"]
    if not period or len(t) < 2:
        return data
    dt = np.mean(np.diff(t))
    spc = int(round(period / dt))
    if spc <= 0:
        return data
    n_cycles = max(1, len(t) // spc)
    end_cycle = min(end_cycle or n_cycles, n_cycles)
    i0 = (start_cycle - 1) * spc
    i1 = end_cycle * spc
    if i0 >= len(t):
        return data

    def cut(x):
        return x[i0:min(i1, len(x))]

    out = dict(data)
    for key in ("time_step", "time", "cpu_time", "ramp_factor", "pressure",
                "min_jacobian"):
        out[key] = cut(np.asarray(data[key]))
    out["flow_properties"] = {
        k: cut(np.asarray(v)) for k, v in data["flow_properties"].items()
    }
    out["probe_points"] = {
        p: {k: cut(np.asarray(v)) for k, v in d.items()}
        for p, d in data["probe_points"].items()
    }
    out["probe_points_displacement"] = {
        p: {k: cut(np.asarray(v)) for k, v in d.items()}
        for p, d in data["probe_points_displacement"].items()
    }
    return out


def phase_average(series, times, period):
    """Cycle-phase average of a series; returns (phase_times, mean)."""
    times = np.asarray(times)
    series = np.asarray(series)
    if len(times) < 2 or not period:
        return None, None
    dt = np.mean(np.diff(times))
    spc = int(round(period / dt))
    if spc <= 0:
        return None, None
    n = min(len(series), len(times)) // spc
    if n < 1:
        return None, None
    seg = series[: n * spc].reshape(n, spc, -1).squeeze(-1) \
        if series.ndim == 1 else series[: n * spc].reshape(n, spc, -1)
    return times[:spc] - times[0], seg.mean(axis=0)


def plot_average(data, out_dir, period):
    """Cycle-averaged variants of the standard figure set (reference
    --compute-average: same basenames, phase-averaged content — image dir
    tests/test_data/reference_images/test_average)."""
    plt = _pyplot()

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    t = data["time"]
    fp = data["flow_properties"]
    figures = []

    def avg_plot(name, series_list, labels, ylabel):
        xs, ys = None, []
        for s in series_list:
            pt, m = phase_average(s, t[: len(s)], period)
            if m is None:
                return
            xs = pt
            ys.append(m)
        path = out / f"{name}.png"
        _save_plot(xs, ys, labels, f"{name} (cycle-averaged)", ylabel, path,
                   xlabel="Phase time [s]")
        figures.append(path)

    avg_plot("cpu_time", [data["cpu_time"]], [""], "CPU time [s]")
    if len(data["ramp_factor"]):
        avg_plot("ramp_factor", [data["ramp_factor"]], [""], "ramp factor")
    if len(data["pressure"]):
        avg_plot("pressure", [data["pressure"]], [""], "Pressure [Pa]")
    avg_plot("flow_rate", [fp["flow_rate"]], [""], "Flow rate [m3/s]")
    avg_plot("velocity",
             [fp["velocity_mean"], fp["velocity_min"], fp["velocity_max"]],
             ["mean", "min", "max"], "Velocity [m/s]")
    avg_plot("cfl", [fp["cfl_mean"], fp["cfl_min"], fp["cfl_max"]],
             ["mean", "min", "max"], "CFL")
    avg_plot("reynolds_numbers",
             [fp["reynolds_mean"], fp["reynolds_min"], fp["reynolds_max"]],
             ["mean", "min", "max"], "Re")
    if data["probe_points"]:
        fig = plt.figure(figsize=_FIGSIZE)
        plotted = False
        for p, d in sorted(data["probe_points"].items()):
            pt, m = phase_average(d["magnitude"], t[: len(d["magnitude"])],
                                  period)
            if m is not None:
                plt.plot(pt, m, label=f"probe {p}")
                plotted = True
        if plotted:
            plt.xlabel("Phase time [s]")
            plt.ylabel("|u| [m/s]")
            plt.legend()
            plt.grid(True)
            _emit_fig(out / "probe_points.png")
            figures.append(out / "probe_points.png")
        plt.close(fig)
        # cycle-averaged TKE (reference --compute-average averages the TKE
        # series over cycles, log_plotter.py:1412-1417; image set
        # tests/test_data/reference_images/test_average/probe_points_tke.png)
        fig = plt.figure(figsize=_FIGSIZE)
        plotted = False
        for p, d in sorted(data["probe_points"].items()):
            pt, m = compute_tke(d["velocity"], t[: len(d["velocity"])],
                                period)
            if m is not None:
                plt.plot(pt, m, label=f"probe {p}")
                plotted = True
        if plotted:
            plt.xlabel("Phase time [s]")
            plt.ylabel("TKE [m2/s2]")
            plt.legend()
            plt.grid(True)
            _emit_fig(out / "probe_points_tke.png")
            figures.append(out / "probe_points_tke.png")
        plt.close(fig)
    return figures


def plot_compare_cycles(data, out_dir, period, probe_ids=None):
    """Per-cycle overlay plots (reference compare-cycles image names:
    {quantity}_comparison.png, probe_points_comparison_{p}.png)."""
    plt = _pyplot()

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    t = data["time"]
    if len(t) < 2 or not period:
        return []
    dt = np.mean(np.diff(t))
    spc = int(round(period / dt))
    if spc <= 0:
        return []
    n_cycles = max(1, len(t) // spc)
    figures = []

    def overlay(path, series, ylabel):
        fig = plt.figure(figsize=_FIGSIZE)
        for c in range(n_cycles):
            seg = np.asarray(series)[c * spc: (c + 1) * spc]
            if len(seg) == 0:
                continue
            plt.plot(np.arange(len(seg)) * dt, seg, label=f"cycle {c + 1}")
        plt.xlabel("Cycle time [s]")
        plt.ylabel(ylabel)
        plt.legend()
        plt.grid(True)
        _emit_fig(path)
        plt.close(fig)
        figures.append(path)

    fp = data["flow_properties"]
    for key, series, ylabel in (
        ("cpu_time", data["cpu_time"], "CPU time [s]"),
        ("ramp_factor", data["ramp_factor"], "ramp factor"),
        ("pressure", data["pressure"], "Pressure [Pa]"),
        ("flow_rate", fp["flow_rate"], "Flow rate"),
        ("velocity", fp["velocity_mean"], "Velocity"),
        ("cfl", fp["cfl_mean"], "CFL"),
        ("reynolds_numbers", fp["reynolds_mean"], "Re"),
    ):
        if len(series) >= spc:
            overlay(out / f"{key}_comparison.png", series, ylabel)
    probes = data["probe_points"]
    ids = probe_ids if probe_ids is not None else sorted(probes)
    for p in ids:
        if p in probes and len(probes[p]["magnitude"]) >= spc:
            overlay(out / f"probe_points_comparison_{p}.png",
                    probes[p]["magnitude"], f"|u| probe {p}")
        # per-cycle TKE overlays (reference plot_probe_points_tke_comparison,
        # log_plotter.py:1063-1097; image names
        # probe_points_tke_comparison_{p}.png)
        if p in probes:
            tke = compute_tke_series(probes[p]["velocity"],
                                     t[: len(probes[p]["velocity"])], period)
            if tke is not None and len(tke) >= spc:
                overlay(out / f"probe_points_tke_comparison_{p}.png",
                        tke, f"TKE probe {p}")
    return figures


# figure-name -> selector flag (reference log_plotter.py:1117-1131)
_SELECTORS = (
    "cpu_time", "ramp_factor", "pressure", "newton_iteration_atol",
    "newton_iteration_rtol", "probe_points", "probe_points_displacement",
    "probe_points_tke", "flow_rate", "velocity", "cfl", "reynolds",
    "min_jacobian",
)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="vasp-tpu-torch-log-plotter")
    # the reference takes the log positionally (log_plotter.py:1116);
    # --log-file is kept as an equivalent spelling
    parser.add_argument("log_file_pos", nargs="?", default=None,
                        metavar="log_file", help="Path to the log file")
    parser.add_argument("--log-file", dest="log_file_opt", default=None)
    # default-off like the reference (log_plotter.py:1145-1146): figures
    # are shown, not written, unless --save is given
    parser.add_argument("--save", "--save-figures", dest="save_figures",
                        action="store_true", default=False)
    parser.add_argument("--output-directory", default=None)
    parser.add_argument("--plot-all", action="store_true")
    for name in _SELECTORS:
        parser.add_argument(f"--plot-{name.replace('_', '-')}",
                            action="store_true")
    parser.add_argument("--probe-points", type=int, nargs="+", default=None)
    parser.add_argument("--compare-cycles", action="store_true")
    parser.add_argument("--compute-average", action="store_true")
    parser.add_argument("--save-probes", action="store_true", default=False)
    parser.add_argument("--period", type=float, default=None,
                        help="cardiac cycle length for TKE / cycle plots")
    parser.add_argument("--start-cycle", type=int, default=1)
    parser.add_argument("--end-cycle", type=int, default=None)
    parser.add_argument("--figure-size", default="10,6",
                        help="width,height inches (reference --figure-size)")
    parser.add_argument("--log-level", type=int, default=20,
                        help="logging level (reference --log-level)")
    args = parser.parse_args(argv)
    args.log_file = args.log_file_opt or args.log_file_pos
    if not args.log_file:
        parser.error("a log file is required (positional or --log-file)")
    import logging
    logging.basicConfig(level=args.log_level)
    global _FIGSIZE, _SAVE
    _FIGSIZE = tuple(float(x) for x in args.figure_size.split(","))
    _SAVE = args.save_figures
    data = parse_log_file(args.log_file)
    if args.period and (args.start_cycle != 1 or args.end_cycle):
        data = trim_cycles(data, args.period, args.start_cycle,
                           args.end_cycle)
    out = args.output_directory or (Path(args.log_file).parent / "Images")
    selected = {name for name in _SELECTORS
                if getattr(args, f"plot_{name}")}
    figs = plot_all(data, out, period=args.period,
                    select=selected or None,
                    probe_ids=args.probe_points,
                    save_probes=args.save_probes)
    if args.compute_average and args.period:
        avg_dir = Path(out) / "average"
        figs += plot_average(data, avg_dir, args.period)
    if args.compare_cycles and args.period:
        cmp_dir = Path(out) / "compare_cycles"
        figs += plot_compare_cycles(data, cmp_dir, args.period,
                                    probe_ids=args.probe_points)
    print(f"Saved {len(figs)} figures to {out}")


if __name__ == "__main__":
    main()
