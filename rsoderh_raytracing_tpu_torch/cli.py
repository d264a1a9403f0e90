"""Command-line interface of the port.

    python -m rsoderh_raytracing_tpu_torch --scene assets/scenes/house.toml

The flag surface of ``rsoderh_raytracing_tpu.cli`` (``--scene``
repeatable with the last one winning, ``--state``, ``--movement-keys``,
``--other-keys`` with exit code 2 on a bad layout, ``--resolution WxH``,
``--mode exact|freerun``, ``--spp``, ``--intersector``, ``--max-bounces``,
``--output`` .png or .hdr, ``--env-index``, ``--hdri-dir``,
``--checkpoint``, ``--save-checkpoint``, ``--quiet``) plus

    --device {cuda,cpu}   where to render (default cuda; raises without a card)
    --view                the interactive terminal viewer on --device
                          (exit code 2 without a TTY)
    --devices SPEC        split the render over a mesh: 'dp:N' (N samples
                          at once) or 'tile:T,dp:S'; N cards on cuda,
                          N slots on the CPU with --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="rsoderh_raytracing_tpu_torch",
        description="Progressive Monte Carlo path tracer, PyTorch/CUDA port.",
    )
    parser.add_argument(
        "--movement-keys",
        default="wasdqe",
        help="Keys used to move camera as a string of 6 characters.",
    )
    parser.add_argument(
        "--other-keys",
        default="cpe",
        help="Keys for mouse capture / print camera state / next"
        " environment (3 characters).",
    )
    parser.add_argument(
        "--state",
        default=None,
        help="Initial camera state (base64, printed after a render;"
        " interchangeable with the reference renderer).",
    )
    parser.add_argument(
        "--scene",
        action="append",
        required=True,
        help="Path to TOML scene descriptor. Repeatable; last one wins.",
    )
    parser.add_argument("--resolution", default="512x512")
    parser.add_argument(
        "--mode",
        choices=("exact", "freerun"),
        default="exact",
        help="exact: every pixel gets exactly --spp samples."
        " freerun: fastest; per-pixel sample counts vary, rendering"
        " continues until the minimum reaches --spp.",
    )
    parser.add_argument("--spp", type=int, default=64)
    parser.add_argument(
        "--intersector",
        choices=("auto", "sweep", "bvh"),
        default="auto",
        help="sweep: the sweep kernels for any scene (chunked where the"
        " chunked route covers it, else every lane against the packed"
        " table). bvh: build the SAH BVH and walk it. auto: on the card the"
        " sweep kernels where the table fits a block's shared memory or the"
        " scene chunks, else the BVH; on --device cpu the reference's rule,"
        " the BVH past 262,144 triangle lanes.",
    )
    parser.add_argument("--max-bounces", type=int, default=10)
    parser.add_argument("--output", default="render.png")
    parser.add_argument("--env-index", type=int, default=0)
    parser.add_argument("--hdri-dir", default=None)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument(
        "--save-checkpoint",
        default=None,
        help="Write accumulation state to this .npz after rendering.",
    )
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="cuda (default): render on the GPU, an error without one."
        " cpu: the plain PyTorch path.",
    )
    parser.add_argument(
        "--devices",
        default=None,
        help="Shard spec, e.g. 'dp:8' to split samples over 8 devices, or"
        " 'tile:2,dp:4'. Cards on cuda; slots on the CPU with --device cpu.",
    )
    parser.add_argument(
        "--view",
        action="store_true",
        help="Open the interactive terminal viewer on --device instead of"
        " writing a single image.",
    )
    parser.add_argument("--quiet", action="store_true")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from rsoderh_raytracing_tpu_torch.scene.camera import Camera, KeyboardLayout

    try:
        layout = KeyboardLayout.parse_config(args.movement_keys, args.other_keys)
    except ValueError as err:
        print(f"Invalid keyboard config: {err}", file=sys.stderr)
        return 2

    from rsoderh_raytracing_tpu_torch.scene.toml_loader import SceneError, load_scene

    try:
        scene = load_scene(args.scene[-1])
    except SceneError as err:
        print(err, file=sys.stderr)
        return 1

    if args.state is not None:
        scene.camera = Camera.deserialize(args.state)

    try:
        width, height = (int(v) for v in args.resolution.lower().split("x"))
    except ValueError:
        print(f"Invalid --resolution '{args.resolution}': expected WxH", file=sys.stderr)
        return 2

    from rsoderh_raytracing_tpu_torch.env.environment import load_default_environments
    from rsoderh_raytracing_tpu_torch.render.renderer import Renderer

    environments = load_default_environments(args.hdri_dir)

    if args.view:
        from rsoderh_raytracing_tpu_torch.viewer.terminal import run_viewer

        return run_viewer(
            scene,
            layout,
            width=width,
            height=height,
            environments=environments,
            max_bounces=args.max_bounces,
            environment_index=args.env_index,
            intersector=args.intersector,
            device=args.device,
        )

    renderer = Renderer(
        scene,
        width=width,
        height=height,
        environments=environments,
        max_bounces=args.max_bounces,
        intersector=args.intersector,
        device=args.device,
    )
    renderer.environment_index = args.env_index % len(environments)

    if args.devices:
        from rsoderh_raytracing_tpu_torch.parallel.sharding import ShardedRenderer

        renderer = ShardedRenderer.wrap(renderer, args.devices)

    if args.checkpoint:
        # Establish the state hash without rendering, so the first step
        # does not reset what the load brings.
        inner = getattr(renderer, "inner", renderer)
        inner._last_state_hash = inner._state_hash()
        renderer.load_checkpoint(args.checkpoint)
        if not args.quiet:
            print(f"Resumed from {args.checkpoint} at {renderer.film.sample_count} spp")

    start = time.perf_counter()
    renderer.render(spp=args.spp, progress=not args.quiet, mode=args.mode)
    elapsed = time.perf_counter() - start
    if args.output.lower().endswith(".hdr"):
        renderer.save_hdr(args.output)
    else:
        renderer.save_png(args.output)
    if args.save_checkpoint:
        renderer.save_checkpoint(args.save_checkpoint)
    if not args.quiet:
        total = renderer.film.sample_count
        print(
            f"Rendered {args.scene[-1]} at {width}x{height}, {total} spp in"
            f" {elapsed:.2f}s -> {args.output}"
        )
        stats = renderer.last_stats
        if stats:
            rays = stats["closest_rays"] + stats["shadow_rays"]
            print(
                f"last step: {rays / 1e6:.1f}M rays,"
                f" {stats['iterations']} wavefront iterations"
            )
        print(f"camera state: {scene.camera.serialize()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
