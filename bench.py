"""Benchmark harness — particle-steps/second on the live device.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "particle-steps/s", "detail": {...}}

The headline metric is sustained particle-steps/second of the jitted
substep on a water dam-break into scenes/cube.obj at ``--n`` particles
(default 1M on an accelerator, 32k on the CPU). ``detail`` names the
device (platform, device_kind, count, and the card's name and power
limit where nvidia-smi exists) and carries ``timed_flags``, the status
bits ORed over the timed substeps, which must be 0 for the number to
stand.

Usage: python bench.py [--n N] [--steps K] [--impl tiles|fused|exact]
                       [--scene cube|none] [--json-only] [--mesh N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp


def build_params(n: int, fluid_name: str = "water"):
    from libclsph_tpu.core.params import derive_parameters
    from libclsph_tpu.models.presets import FLUIDS

    sim = dict(
        particles_count=n,
        particle_mass=0.05,
        simulation_time=3,
        target_fps=60,
        simulation_scale=0.1,
        constant_acceleration=dict(x=0, y=-9.8, z=0),
    )
    return derive_parameters(dict(FLUIDS[fluid_name]), sim)


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=None, help="particle count")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument(
        "--scene", default="cube",
        help="scenes/<name>.obj collision mesh, or 'none' (free space)",
    )
    ap.add_argument("--fluid", default="water", choices=["water", "mucus"])
    ap.add_argument(
        "--impl", default=None, choices=["tiles", "fused", "exact"],
        help="the neighbour path to time; default: the platform's "
        "(libclsph_tpu/platform.py). Another value is a comparison run",
    )
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--max-candidates", type=int, default=96)
    ap.add_argument("--sort-interval", type=int, default=4,
                    help="re-sort every k-th substep (1 = every substep)")
    ap.add_argument("--json-only", action="store_true")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run the sharded frame loop over the first N "
                    "devices (on the CPU: XLA_FLAGS=--xla_force_host_"
                    "platform_device_count=N JAX_PLATFORMS=cpu for a "
                    "virtual mesh — shapes and collective counts only)")
    ap.add_argument("--exchange", default="all_gather",
                    choices=["all_gather", "halo", "ring"])
    ap.add_argument("--halo-max", type=int, default=0)
    ap.add_argument("--halo-hops", type=int, default=1)
    return ap


def device_detail() -> dict:
    from libclsph_tpu.platform import gpu_card

    dev = jax.devices()[0]
    return dict(
        platform=dev.platform, device_kind=dev.device_kind,
        device_count=len(jax.devices()), card=gpu_card(),
    )


def count_collectives(fn, *args) -> dict:
    """Collective primitives in ``fn``'s jaxpr, by name."""
    colls = {}
    names = ("ppermute", "all_gather", "psum", "pmin", "pmax",
             "reduce_scatter", "all_to_all", "psum_invariant")

    def walk(jx):
        if hasattr(jx, "jaxpr"):  # ClosedJaxpr
            jx = jx.jaxpr
        for eqn in jx.eqns:
            if eqn.primitive.name in names:
                colls[eqn.primitive.name] = colls.get(eqn.primitive.name, 0) + 1
            for sub in eqn.params.values():
                subs = sub if isinstance(sub, (list, tuple)) else [sub]
                for s2 in subs:
                    if hasattr(s2, "eqns") or hasattr(s2, "jaxpr"):
                        walk(s2)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return colls


def bench_mesh(args, params, cfg, scene_dev, state, dt, n, log):
    """--mesh N: the sharded device-side frame loop (make_sharded_frame)
    for --steps substeps' worth of frame budget over the first N
    devices, plus the per-dispatch collective counts from the jaxpr."""
    from libclsph_tpu.engine.step import FLAG_CAPACITY
    from libclsph_tpu.parallel.mesh import make_mesh, particle_sharding
    from libclsph_tpu.parallel.sharded_step import (
        make_sharded_frame, pad_for_mesh,
    )

    devices = jax.devices()[: args.mesh]
    if len(devices) < args.mesh:
        sys.exit(f"only {len(devices)} device(s); requested {args.mesh}")
    mesh = make_mesh(devices)
    state = pad_for_mesh(state, params, mesh, cfg)
    state = jax.tree.map(
        lambda a: jax.device_put(a, particle_sharding(mesh)), state
    )

    def build(cfg):
        return make_sharded_frame(
            mesh, params, scene_dev, cfg, exchange=args.exchange,
            halo_max=args.halo_max or state.position.shape[0]
            // args.mesh // cfg.block_size,
            halo_hops=args.halo_hops or (args.mesh + 1) // 2,
        )

    frame = build(cfg)
    colls = count_collectives(
        frame, state, dt, jnp.float32(params.frame_time)
    )

    # warmup (one whole frame's budget), growing the candidate capacity
    # like the engine until the timed run can certify timed_flags == 0
    t0 = time.perf_counter()
    for _ in range(5):
        st, d, tl, flags = frame(state, dt, jnp.float32(params.frame_time))
        jax.block_until_ready(st.position)
        if not int(flags) & FLAG_CAPACITY:
            break
        cfg = dataclasses.replace(cfg, max_candidates=cfg.max_candidates * 2)
        log(f"mesh warmup flags {int(flags)} -> max_candidates {cfg.max_candidates}")
        frame = build(cfg)
    log(f"compile+warmup: {time.perf_counter() - t0:.1f}s flags={int(flags)}")

    budget = float(params.max_dt) * args.steps
    t0 = time.perf_counter()
    st, d, tl, flags = frame(state, dt, jnp.float32(budget))
    jax.block_until_ready(st.position)
    elapsed = time.perf_counter() - t0
    steps = args.steps  # dt starts at max_dt and only shrinks
    return {
        "metric": (
            f"sharded particle-steps/sec @ {n} x {args.mesh} devices "
            f"(exchange={args.exchange})"
        ),
        "value": n * steps / elapsed,
        "unit": "particle-steps/s",
        "detail": dict(
            device_detail(), n=n, mesh=args.mesh, exchange=args.exchange,
            impl=cfg.neighbor_impl, elapsed_s=elapsed,
            ms_per_step=1000 * elapsed / steps, timed_flags=int(flags),
            collectives_per_frame_dispatch=colls,
        ),
    }


def run(argv=None) -> dict:
    """Run the benchmark in this process; returns the result record."""
    from libclsph_tpu import platform
    from libclsph_tpu.core.state import init_state
    from libclsph_tpu.engine.step import FLAG_CAPACITY, StepConfig, substep_jit
    from libclsph_tpu.ops import collisions as collisions_ops
    from libclsph_tpu.scene.scene import Scene

    args = build_arg_parser().parse_args(argv)
    platform.enable_compile_cache()
    on_cpu = jax.devices()[0].platform == "cpu"
    n = args.n or (32_768 if on_cpu else 1_000_000)

    params = build_params(n, args.fluid)
    cfg = StepConfig(
        neighbor_impl=args.impl or platform.neighbor_impl(),
        block_size=args.block_size,
        max_candidates=args.max_candidates,
        sort_interval=args.sort_interval,
    )
    scene_dev = None
    if args.scene != "none":
        scene = Scene.load(
            args.scene + ".obj", params.h * 2,
            scenes_dir=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "scenes"),
        )
        scene_dev = collisions_ops.build_device_scene(scene)

    state = init_state(params)
    dt = jnp.float32(params.max_dt)

    def log(msg):
        if not args.json_only:
            print(msg, file=sys.stderr)

    log(f"n={n} impl={cfg.neighbor_impl} scene={args.scene}")
    if args.mesh:
        return bench_mesh(args, params, cfg, scene_dev, state, dt, n, log)

    def substeps(s, d, count):
        flags = jnp.int32(0)
        for i in range(count):
            s, d, f = substep_jit(
                s, d, params, scene_dev, cfg,
                do_sort=i % cfg.sort_interval == 0,
            )
            # OR across substeps: a NaN'd state stops overflowing,
            # masking an early truncation
            flags = flags | f
        return s, d, flags

    # warmup + compile; grow the candidate capacity until no overflow
    # (mirrors the engine's autotune) so the timed physics is exact
    t0 = time.perf_counter()
    for _ in range(6):
        s_try, d_try, flags = substeps(state, dt, args.warmup)
        jax.block_until_ready(s_try.position)
        if not int(flags) & FLAG_CAPACITY:
            break
        cfg = dataclasses.replace(cfg, max_candidates=cfg.max_candidates * 2)
        log(f"capacity overflow -> max_candidates {cfg.max_candidates}")
    state, dt = s_try, d_try
    compile_s = time.perf_counter() - t0
    log(f"compile+warmup: {compile_s:.1f}s")

    t0 = time.perf_counter()
    state, dt, timed_flags = substeps(state, dt, args.steps)
    jax.block_until_ready(state.position)
    elapsed = time.perf_counter() - t0
    if int(timed_flags):
        log(f"WARNING: flags {int(timed_flags)} raised during the timed run")

    return {
        "metric": f"particle-steps/sec {args.fluid} dam-break @ {n} particles",
        "value": n * args.steps / elapsed,
        "unit": "particle-steps/s",
        "detail": dict(
            device_detail(), n=n, steps=args.steps, elapsed_s=elapsed,
            ms_per_step=1000 * elapsed / args.steps, impl=cfg.neighbor_impl,
            max_candidates=cfg.max_candidates,
            sort_interval=cfg.sort_interval, scene=args.scene,
            compile_warmup_s=compile_s, final_dt=float(dt),
            timed_flags=int(timed_flags),
        ),
    }


def main():
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
