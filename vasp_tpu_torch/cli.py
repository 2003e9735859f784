"""Console entry points of the port's postprocessing: vasp_tpu.cli's
entries under vasp-tpu-torch-* names (pyproject.toml). Each entry that
reaches a kernel takes --device (default cuda; cuda without a card raises,
--device cpu runs the plain torch versions). The meshing entries
(vasp-generate-mesh, vasp-generate-solid-probe) are not ported yet
(ROADMAP.md queue 1, item 16)."""
import argparse
from pathlib import Path


def _folder_parser(prog, extra=None, device=False):
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("--folder", required=True, help="simulation results folder")
    p.add_argument("--mesh-path", default=None)
    if device:
        p.add_argument("--device", default="cuda",
                       help="where the K20 kernels run: cuda (default) or "
                            "cpu (the plain torch versions)")
    if extra:
        extra(p)
    return p


# ---------------- mesh stages ----------------
def refine_mesh(argv=None):
    from vasp_tpu_torch.postprocessing.mesh_stages import create_refined_mesh

    args = _folder_parser("vasp-tpu-torch-refine-mesh").parse_args(argv)
    out = create_refined_mesh(args.folder, args.mesh_path)
    print(f"Refined mesh written to {out}")


def separate_mesh(argv=None):
    from vasp_tpu_torch.postprocessing.mesh_stages import separate_mesh as _sep

    def extra(p):
        p.add_argument("--fluid-domain-id", type=int, default=1)
        p.add_argument("--solid-domain-id", type=int, default=2)

    args = _folder_parser("vasp-tpu-torch-separate-mesh",
                          extra).parse_args(argv)
    outs = _sep(args.folder, args.mesh_path, args.fluid_domain_id,
                args.solid_domain_id)
    for o in outs:
        print(f"Wrote {o}")


def predeform_mesh(argv=None):
    from vasp_tpu_torch.postprocessing.mesh_stages import (
        predeform_mesh as _pre,
    )

    def extra(p):
        p.add_argument("--scale-factor", type=float, default=-1.0)

    args = _folder_parser("vasp-tpu-torch-predeform-mesh",
                          extra).parse_args(argv)
    out = _pre(args.folder, args.mesh_path, args.scale_factor)
    print(f"Predeformed mesh written to {out}")


# ---------------- field conversions ----------------
def create_hdf5(argv=None):
    from vasp_tpu_torch.postprocessing.fields.create_hdf5 import (
        create_hdf5 as _ch,
    )

    def extra(p):
        p.add_argument("--extract-entire-domain", action="store_true")
        p.add_argument("--stride", type=int, default=1)
        p.add_argument("--start-time", type=float, default=None)
        p.add_argument("--end-time", type=float, default=None)

    args = _folder_parser("vasp-tpu-torch-create-hdf5", extra).parse_args(argv)
    outs = _ch(args.folder, args.mesh_path,
               extract_solid_only=not args.extract_entire_domain,
               stride=args.stride, start_time=args.start_time,
               end_time=args.end_time)
    for o in outs:
        print(f"Wrote {o}")


def create_separate_domain_viz(argv=None):
    from vasp_tpu_torch.postprocessing.fields.create_hdf5 import (
        create_separate_domain_visualization,
    )

    args = _folder_parser(
        "vasp-tpu-torch-create-separate-domain-viz").parse_args(argv)
    outs = create_separate_domain_visualization(args.folder, args.mesh_path)
    for o in outs:
        print(f"Wrote {o}")


def compute_hemo(argv=None):
    from vasp_tpu_torch.postprocessing.fields.hemodynamics import (
        compute_hemodynamics,
    )

    def extra(p):
        p.add_argument("--n-devices", type=int, default=None,
                       help="ranks the timesteps are sharded over (started "
                            "here, or a launcher's group); rank 0 writes")
        p.add_argument("--dist-backend", default=None,
                       help="gloo or nccl (default: nccl on cuda, gloo on "
                            "cpu; gloo for ranks sharing one card)")

    args = _folder_parser("vasp-tpu-torch-compute-hemo", extra,
                          device=True).parse_args(argv)
    compute_hemodynamics(args.folder, args.mesh_path,
                         n_devices=args.n_devices, device=args.device,
                         dist_backend=args.dist_backend)
    print(f"Hemodynamic indices written to "
          f"{Path(args.folder) / 'Hemodynamic_indices'}")


def compute_stress(argv=None):
    from vasp_tpu_torch.postprocessing.fields.stress_strain import (
        compute_stress_strain,
    )

    def extra(p):
        p.add_argument("--stride", type=int, default=1)
        p.add_argument("--n-devices", type=int, default=None,
                       help="ranks the timesteps are sharded over (started "
                            "here, or a launcher's group); rank 0 writes")
        p.add_argument("--dist-backend", default=None,
                       help="gloo or nccl (default: nccl on cuda, gloo on "
                            "cpu; gloo for ranks sharing one card)")

    args = _folder_parser("vasp-tpu-torch-compute-stress", extra,
                          device=True).parse_args(argv)
    compute_stress_strain(args.folder, args.mesh_path, stride=args.stride,
                          n_devices=args.n_devices, device=args.device,
                          dist_backend=args.dist_backend)
    print(f"Stress/strain written to {Path(args.folder) / 'StressStrain'}")


# ---------------- spectral ----------------
def _spectral_parser(prog):
    def extra(p):
        p.add_argument("-q", "--quantity", default="v",
                       choices=["v", "d", "p", "wss", "mps", "stress",
                                "strain"])
        p.add_argument("--start-time", type=float, default=None)
        p.add_argument("--end-time", type=float, default=None)
        p.add_argument("--lowcut", type=float, default=25.0)
        p.add_argument("--ylim", type=float, default=None)
        p.add_argument("--sampling-region", default="sphere",
                       choices=["sphere", "box", "domain"])
        p.add_argument("--fluid-sampling-domain", action="store_true",
                       default=True)
        p.add_argument("--solid-sampling-domain", action="store_true",
                       default=False)
        p.add_argument("--n-samples", type=int, default=10000)
        p.add_argument("--num-windows-per-sec", type=float, default=4.0)
        p.add_argument("--overlap-frac", type=float, default=0.75)
        p.add_argument("--window", default="blackmanharris")
        p.add_argument("--min-color", type=float, default=None)
        p.add_argument("--max-color", type=float, default=None)
        p.add_argument("--n-chroma", type=int, default=24)
        p.add_argument("--sonify", action="store_true",
                       help="also export the first sampled point's series "
                            "as WAV (reference: spectrograms.py:817-852)")
    return _folder_parser(prog, extra, device=True)


def _load_spectral_data(args):
    from vasp_tpu_torch.postprocessing.spectral.transform import (
        read_spectrogram_data,
    )

    data, times, fs = read_spectrogram_data(
        args.folder, args.mesh_path, quantity=args.quantity,
        n_samples=args.n_samples,
        fluid_sampling_domain=args.fluid_sampling_domain
        and not args.solid_sampling_domain,
        solid_sampling_domain=args.solid_sampling_domain,
        start_t=args.start_time, end_t=args.end_time,
    )
    return data, times, fs


def create_spectrograms_chromagrams(argv=None):
    from vasp_tpu_torch.postprocessing.spectral.figures import (
        QUANTITY_COLORS,
        create_spectrogram_composite,
    )

    args = _spectral_parser(
        "vasp-tpu-torch-create-spectrograms-chromagrams"
    ).parse_args(argv)
    data, times, fs = _load_spectral_data(args)
    cmin, cmax = QUANTITY_COLORS.get(args.quantity, (-20, -2.5))
    if args.min_color is not None:
        cmin = args.min_color
    if args.max_color is not None:
        cmax = args.max_color
    start_t = args.start_time if args.start_time is not None else times[0]
    end_t = args.end_time if args.end_time is not None else times[-1]
    out = Path(args.folder) / "Spectrograms"
    create_spectrogram_composite(
        Path(args.folder).name, args.quantity, data, times, start_t, end_t,
        args.num_windows_per_sec, args.overlap_frac, args.window,
        args.lowcut, cmin, cmax, out, ylim=args.ylim,
        n_chroma=args.n_chroma, device=args.device,
    )
    if args.sonify and len(data):
        from vasp_tpu_torch.postprocessing.spectral.core import sonify

        fs_data = fs
        wav = out / f"{args.quantity}_point0.wav"
        sonify(data[0], fs_audio=max(8000, int(20 * fs_data)), path=wav,
               fs_data=fs_data)
        print(f"Sonified point 0 to {wav}")
    print(f"Spectrograms written to {out}")


def create_spectrum(argv=None):
    from vasp_tpu_torch.postprocessing.spectral.figures import (
        create_spectrum as _cs,
    )

    args = _spectral_parser("vasp-tpu-torch-create-spectrum").parse_args(argv)
    data, times, fs = _load_spectral_data(args)
    start_t = args.start_time if args.start_time is not None else times[0]
    end_t = args.end_time if args.end_time is not None else times[-1]
    out = Path(args.folder) / "Spectrograms"
    _cs(Path(args.folder).name, args.quantity, data, times, start_t, end_t,
        out, lowcut=args.lowcut, ylim=args.ylim, device=args.device)
    print(f"Spectrum written to {out}")


def create_hi_pass_viz(argv=None):
    from vasp_tpu_torch.postprocessing.spectral.hi_pass_viz import (
        create_hi_pass_viz as _hp,
    )

    def extra(p):
        p.add_argument("-q", "--quantity", default="d",
                       choices=["v", "d", "p", "strain"])
        p.add_argument("--lowcut", type=float, default=25.0)
        p.add_argument("--highcut", type=float, default=100000.0)
        p.add_argument("--filter-type", default="bandpass")
        p.add_argument("--no-amplitude", action="store_true")

    args = _folder_parser("vasp-tpu-torch-create-hi-pass-viz", extra,
                          device=True).parse_args(argv)
    _hp(args.folder, quantity=args.quantity, lowcut=args.lowcut,
        highcut=args.highcut, filter_type=args.filter_type,
        mesh_path=args.mesh_path, amplitude=not args.no_amplitude,
        device=args.device)
    print(
        f"Hi-pass visualization written to "
        f"{Path(args.folder) / 'Visualization_hi_pass'}"
    )


# ---------------- misc ----------------
def log_plotter(argv=None):
    from vasp_tpu_torch.postprocessing.log_plotter import main as _main

    _main(argv)
