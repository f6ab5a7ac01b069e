"""`raytrace-tpu-torch` console entry point: render a pbrt-v2 scene file
with the port (port of raytrace_tpu/cli.py).

    raytrace-tpu-torch scene.pbrt -o out.png --photon-paths 65536 --passes 4

The renderer is chosen by the scene's Renderer statement ("simple" → direct
lighting only, anything else → photon mapping, mirroring
cudarender.cpp:126-134), overridable with --renderer. The output format
follows the extension: .exr and .pfm are linear float, anything else a
gamma-mapped PNG. It renders on the CUDA device, or on the CPU with --cpu;
without --cpu and without CUDA it raises.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from raytrace_tpu_torch.core import prng
from raytrace_tpu_torch.core.config import RenderConfig
from raytrace_tpu_torch.renderers.photon import (
    render_photon,
    render_photon_progressive,
)
from raytrace_tpu_torch.renderers.simple import render_simple
from raytrace_tpu_torch.scene.pbrt import load_pbrt
from raytrace_tpu_torch.utils import image as img_io
from raytrace_tpu_torch.utils import metrics


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="raytrace-tpu-torch",
                                 description=__doc__)
    ap.add_argument("scene", help="pbrt-v2 scene file")
    ap.add_argument("-o", "--out",
                    default=os.path.join(tempfile.gettempdir(), "render.png"))
    ap.add_argument("--renderer", choices=("auto", "simple", "photon"),
                    default="auto")
    ap.add_argument("--photon-paths", type=int, default=1 << 16)
    ap.add_argument("--passes", type=int, default=1)
    ap.add_argument("--spp", type=int, default=0, help="override sampler spp")
    ap.add_argument("--seed", type=int, default=777)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--footprint-radius-scale", type=float, default=0.0,
                    help="SPPM footprint-seeded initial radii (0 = off)")
    ap.add_argument("--checkpoint", default=None,
                    help="progressive checkpoint path (resume if it exists)")
    ap.add_argument("--pfm", default=None, help="also write raw PFM here")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        raise RuntimeError("raytrace-tpu-torch: no CUDA device; pass --cpu "
                           "to render on the CPU")

    t0 = time.perf_counter()
    parsed = load_pbrt(args.scene, device)
    print(f"parsed {args.scene}: {parsed.width}x{parsed.height} "
          f"renderer={parsed.renderer} ({time.perf_counter()-t0:.1f}s)")

    config = RenderConfig(
        width=parsed.width, height=parsed.height,
        spp=args.spp or parsed.spp, scene_epsilon=1e-3,
        photon_paths=args.photon_paths, photon_passes=args.passes,
        seed=args.seed,
        footprint_radius_scale=args.footprint_radius_scale,
        pixel_filter=parsed.pixel_filter,
    )
    key = prng.PRNGKey(args.seed, device)
    which = args.renderer
    if which == "auto":
        which = "simple" if parsed.renderer == "simple" else "photon"

    with metrics.Throughput() as t:
        if which == "simple":
            img = render_simple(parsed.scene, parsed.camera, config, key)
        elif args.checkpoint or args.passes > 1:
            img, _ = render_photon_progressive(
                parsed.scene, parsed.camera, config, key,
                checkpoint_path=args.checkpoint, verbose=True)
        else:
            img = render_photon(parsed.scene, parsed.camera, config, key)
        if img.is_cuda:
            torch.cuda.synchronize(img.device)
    rays = config.n_pixel_samples
    print(f"rendered in {t.seconds:.2f}s  ({t.rate(rays)/1e6:.3f} Mrays/s, "
          f"{t.rate(config.photon_paths * config.photon_passes)/1e6:.3f} "
          f"Mphotons/s)")

    # dispatch by extension: .exr = linear float (the reference's film
    # output format, photonmappingrenderer.cpp:283), .pfm = linear float,
    # anything else = gamma-mapped PNG
    img = img.detach().cpu().numpy()
    out = str(args.out)
    if out.endswith(".exr"):
        img_io.write_exr(out, img)
    elif out.endswith(".pfm"):
        img_io.write_pfm(out, img)
    else:
        img_io.write_png(out, img)
    print(f"wrote {out}")
    if args.pfm:
        img_io.write_pfm(args.pfm, img)
        print(f"wrote {args.pfm}")


if __name__ == "__main__":
    main()
