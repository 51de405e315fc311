"""Headless CLI — the reference's example/particles.cpp as a console
entry point.

Same four positional arguments (particles.cpp:13-16):

    python -m libclsph_tpu.cli <fluid> <sim_properties> <scene> <out_prefix>

resolving ``fluid_properties/<fluid>.json``,
``simulation_properties/<sim>.json`` and ``scenes/<scene>`` exactly like
the reference (particles.cpp:23-25, :67), printing the same parameter
table (:42-65), wiring the Houdini frame saver + checkpoint callback
(:32-40), and timing the run (:102-109). Extra flags are additive
capabilities (no interactive confirm by default; ``--confirm``
restores it).
"""

from __future__ import annotations

import argparse
import os
import sys

from . import platform
from .engine.simulation import SPHSimulation
from .engine.step import StepConfig
from .io.houdini import HoudiniFileSaver


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="sph",
        description="SPH fluid simulation in JAX (libclsph-tpu)",
    )
    ap.add_argument("fluid", help="fluid properties name (fluid_properties/<name>.json)")
    ap.add_argument(
        "simulation", help="simulation properties name (simulation_properties/<name>.json)"
    )
    ap.add_argument("scene", help="scene OBJ name (scenes/<name>[.obj])")
    ap.add_argument("out_prefix", help="frames folder prefix")
    ap.add_argument("--partio", action="store_true", help="write .bgeo instead of .geo")
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--max-candidates", type=int, default=64)
    ap.add_argument(
        "--sort-interval", type=int, default=4,
        help="re-sort particles every k-th substep",
    )
    ap.add_argument(
        "--confirm", action="store_true",
        help="ask for confirmation before simulating (reference behaviour)",
    )
    ap.add_argument(
        "--import-legacy", metavar="LAST_FRAME_BIN", default=None,
        help="resume from a reference-format last_frame.bin checkpoint",
    )
    ap.add_argument(
        "--mesh", type=int, default=0, metavar="N",
        help="run data-parallel over the first N devices (0 = single device)",
    )
    ap.add_argument(
        "--exchange", choices=["all_gather", "halo", "ring"],
        default="all_gather",
        help="multi-chip neighbour exchange strategy (with --mesh)",
    )
    ap.add_argument(
        "--halo-max", type=int, default=0,
        help="surface-block budget for halo/ring exchange (0 = all blocks)",
    )
    ap.add_argument(
        "--halo-hops", type=int, default=1,
        help="ring exchange: ppermute hops per direction",
    )
    ap.add_argument("--root", default=".", help="directory holding fluid_properties/ etc.")
    return ap


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    platform.enable_compile_cache()
    cfg = StepConfig(
        neighbor_impl=platform.neighbor_impl(),
        block_size=args.block_size,
        max_candidates=args.max_candidates,
        sort_interval=args.sort_interval,
    )
    mesh = None
    if args.mesh:
        import jax

        from .parallel.mesh import make_mesh

        devices = jax.devices()[: args.mesh]
        if len(devices) < args.mesh:
            print(
                f"only {len(devices)} device(s) available, requested {args.mesh}",
                file=sys.stderr,
            )
            return -1
        mesh = make_mesh(devices)
    simulation = SPHSimulation(
        step_config=cfg, mesh=mesh, exchange=args.exchange,
        halo_max=args.halo_max, halo_hops=args.halo_hops,
    )
    saver = HoudiniFileSaver(args.out_prefix, use_partio=args.partio)

    try:
        simulation.load_settings(
            os.path.join(args.root, "fluid_properties", args.fluid + ".json"),
            os.path.join(args.root, "simulation_properties", args.simulation + ".json"),
        )
    except Exception as ex:  # same failure path as particles.cpp:27-30
        print(ex, file=sys.stderr)
        return -1

    if args.mesh and args.exchange in ("halo", "ring") and not args.halo_max:
        # default surface budget: every local block may be surface
        n = simulation.parameters.particles_count
        chunk = args.mesh * args.block_size
        padded = -(-n // chunk) * chunk
        simulation.halo_max = padded // chunk

    def save_frame(arrays, params):
        saver.write_frame_to_file(arrays, params)

    simulation.save_frame = save_frame

    p = simulation.parameters
    print(
        f"""
Loaded parameters
-----------------
Simulation time:           {p.simulation_time:g}
Target FPS:                {p.target_fps:g}
Simulation scale:          {p.simulation_scale:g}
Write intermediate frames: {'true' if simulation.write_intermediate_frames else 'false'}
Serialize frames:          {'true' if simulation.serialize else 'false'}

Particle count:            {p.particles_count}
Particle mass:             {p.particle_mass:g}
Total mass:                {p.total_mass:g}
Initial volume:            {simulation.initial_volume:g}

Fluid density:             {p.fluid_density:g}
Dynamic viscosity:         {p.dynamic_viscosity:g}
Surface tension threshold: {p.surface_tension_threshold:g}
Surface tension:           {p.surface_tension:g}
Stiffness (k):             {p.K:g}
Restitution:               {p.restitution:g}

Kernel support radius (h): {p.h:g}

Saving to folder:          {args.out_prefix}frames/"""
    )

    scene_name = args.scene if args.scene.endswith(".obj") else args.scene + ".obj"
    try:
        simulation.load_scene(scene_name, scenes_dir=os.path.join(args.root, "scenes"))
    except Exception as ex:
        print(f"Unable to load scene: {args.scene} ({ex})", file=sys.stderr)
        return -1

    if args.import_legacy:
        from .io.checkpoint import save_checkpoint
        from .io.legacy import read_legacy_checkpoint

        try:
            arrays = read_legacy_checkpoint(
                args.import_legacy, simulation.parameters.particles_count
            )
        except (OSError, ValueError) as ex:
            print(ex, file=sys.stderr)
            return 1
        save_checkpoint(simulation.checkpoint_path, arrays, simulation.parameters)
        print(f"Imported legacy checkpoint {args.import_legacy}")

    if args.confirm:
        print(
            "\nRevise simulation parameters. Press q to quit, any other "
            "key to proceed with simulation"
        )
        if input().strip().lower() == "q":
            return 0

    try:
        duration = simulation.simulate()
    except RuntimeError as ex:
        # e.g. stale checkpoint (reference aborts similarly on a
        # wrong-size last_frame.bin, particles.cpp:89-92)
        print(ex, file=sys.stderr)
        return 1
    print(f"Duration : {duration:g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
