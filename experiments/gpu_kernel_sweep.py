"""Fused GPU kernels against the XLA tiles passes, on the card.

Builds the water dam-break lattice at 64,000 particles (the reference's
simulation_properties/default.json) and at 1M (bench.py's width), runs
the candidate search once, then for each pass:

* checks every kernel tile shape against the XLA tiles pass (float32,
  ``jax.default_matmul_precision("highest")``),
* times the XLA pass and every kernel tile shape alone,

and finally times the full substep (``substep_jit``) with
``neighbor_impl="tiles"`` and ``"fused"`` from the same state, in turns.
``--bench`` instead runs bench.py's substep loop (the cube dam-break)
for both paths in turns (tiles, fused, fused, tiles), in this process.

Run on a machine with an NVIDIA GPU:

    python experiments/gpu_kernel_sweep.py [--quick | --bench]

Prints one JSON object per measurement and writes them all to
chiprun_out/gpu_kernel_sweep.jsonl.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from bench import build_params  # noqa: E402
from chip_smoke import rel_max, rel_rms, sorted_blocks  # noqa: E402
from libclsph_tpu import platform  # noqa: E402
from libclsph_tpu.core.state import init_state  # noqa: E402
from libclsph_tpu.engine.step import StepConfig, substep_jit  # noqa: E402
from libclsph_tpu.ops import interactions  # noqa: E402
from libclsph_tpu.ops import tiles as tiles_ops  # noqa: E402
from libclsph_tpu.ops.pallas import neighbor_gpu  # noqa: E402

B = 128
SHAPES = [  # (query_tile, cand_tile, num_warps, num_stages)
    (16, 128, 4, 2), (32, 32, 2, 2), (16, 64, 2, 2), (64, 64, 8, 3),
    (32, 64, 4, 2), (16, 32, 1, 2), (32, 128, 8, 2), (16, 128, 4, 3),
]
QUICK_SHAPES = [tuple(neighbor_gpu.DENSITY_SHAPE), tuple(neighbor_gpu.FORCE_SHAPE)]


def timeit(fn, *args, reps=10):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return 1e3 * (time.perf_counter() - t0) / reps


def run(n, shapes, emit, substeps):
    params = build_params(n)
    terms = params.precomputed()
    cap = 64 if n <= 64000 else 96  # the smallest that holds the lattice
    state = init_state(params)
    rng = np.random.default_rng(0)
    state = state.replace(velocity=jnp.asarray(
        rng.normal(0.0, 0.3, state.velocity.shape), jnp.float32))
    blocked, real, cand, count = sorted_blocks(state, params, B, cap)
    cnt = np.asarray(count)
    emit(dict(n=n, what="candidates", max_candidates=cap,
              count_mean=float(cnt.mean()), count_max=int(cnt.max())))
    cfg = tiles_ops.TileConfig(block_size=B, max_candidates=cap)
    mask = np.asarray(real)

    with jax.default_matmul_precision("highest"):
        dens_t = jax.jit(
            lambda bl, c, k: tiles_ops.density_pass(bl, c, k, params, terms, cfg)
        )
        d_ref = dens_t(blocked, cand, count)
        ms = timeit(dens_t, blocked, cand, count)
        emit(dict(n=n, what="density", impl="tiles", ms=ms))
        p = jnp.where(real, interactions.tait_pressure(d_ref, params), 0.0)
        blocked = blocked._replace(
            density=d_ref.reshape(blocked.density.shape),
            pressure=p.reshape(blocked.pressure.shape),
        )
        force_t = jax.jit(
            lambda bl, c, k: tiles_ops.force_pass(bl, c, k, params, terms, cfg)
        )
        a_ref = force_t(blocked, cand, count)
        ms = timeit(force_t, blocked, cand, count)
        emit(dict(n=n, what="forces", impl="tiles", ms=ms))

    dpack = neighbor_gpu.pack_density(blocked)
    fpack = neighbor_gpu.pack_forces(blocked, params.particle_mass)
    for qt, ct, nw, ns in shapes:
        kw = dict(shape=neighbor_gpu.KernelShape(qt, ct, nw, ns))
        tag = dict(n=n, impl="fused", query_tile=qt, cand_tile=ct,
                   num_warps=nw, num_stages=ns)
        try:
            dens_k = jax.jit(lambda pk, c, k, kw=kw: neighbor_gpu.fused_density(
                pk, pk, c, k, params, terms, **kw))
            force_k = jax.jit(lambda pk, d, c, k, kw=kw: neighbor_gpu.fused_forces(
                pk, d, pk, c, k, params, terms, **kw))
            d = dens_k(dpack, cand, count)
            rms, mx = rel_rms(d[mask], d_ref[mask]), rel_max(d[mask], d_ref[mask])
            emit(dict(tag, what="density",
                      ms=timeit(dens_k, dpack, cand, count),
                      rel_rms=rms, rel_max=mx))
            a = force_k(fpack, d_ref, cand, count)
            rms, mx = rel_rms(a[mask], a_ref[mask]), rel_max(a[mask], a_ref[mask])
            emit(dict(tag, what="forces",
                      ms=timeit(force_k, fpack, d_ref, cand, count),
                      rel_rms=rms, rel_max=mx))
        except Exception as e:  # a refused shape must not end the sweep
            emit(dict(tag, error=repr(e)[:3000]))

    # full substep, tiles / fused / fused / tiles, from the same state
    state = init_state(params)
    dt = jnp.float32(params.max_dt)
    for impl in ("tiles", "fused", "fused", "tiles"):
        scfg = StepConfig(neighbor_impl=impl, max_candidates=cap)
        s, d, f = substep_jit(state, dt, params, None, scfg)
        jax.block_until_ready(s.position)
        t0 = time.perf_counter()
        s, d = state, dt
        flags = jnp.int32(0)
        for _ in range(substeps):
            s, d, f = substep_jit(s, d, params, None, scfg)
            flags = flags | f
        jax.block_until_ready(s.position)
        emit(dict(n=n, what="substep", impl=impl, flags=int(flags),
                  ms=1e3 * (time.perf_counter() - t0) / substeps))
    if n == 1_000_000:
        scfg = StepConfig(neighbor_impl="fused", max_candidates=cap)
        mem = substep_jit.lower(
            state, dt, params, None, scfg
        ).compile().memory_analysis()
        emit(dict(n=n, what="memory_analysis", text=str(mem)))


def bench_turns(n, emit, steps=20):
    """bench.py at the smallest candidate capacity that holds this
    width (the tiles passes scan every slot, live or not)."""
    import bench

    cap = 64 if n <= 64000 else 96
    for impl in ("tiles", "fused", "fused", "tiles"):
        res = bench.run(["--n", str(n), "--impl", impl, "--steps", str(steps),
                         "--max-candidates", str(cap), "--json-only"])
        emit(dict(n=n, what="bench", impl=impl, **{
            k: res["detail"][k] for k in (
                "ms_per_step", "timed_flags", "max_candidates",
                "sort_interval", "compile_warmup_s", "steps")
        }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--bench", action="store_true",
                    help="bench.py's substep loop for both paths, in turns")
    ap.add_argument("--n", type=int, nargs="*", default=[64000, 1_000_000])
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit("needs a GPU")
    os.makedirs("chiprun_out", exist_ok=True)
    out = open("chiprun_out/gpu_kernel_sweep.jsonl", "a")
    hw = dict(card=platform.gpu_card(), kind=jax.devices()[0].device_kind)
    print(json.dumps(hw), flush=True)

    def emit(rec):
        rec = dict(rec, **hw)
        line = json.dumps(rec)
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    for n in args.n:
        if args.bench:
            bench_turns(n, emit)
        else:
            run(n, QUICK_SHAPES if args.quick else SHAPES, emit, substeps=10)
    out.close()


if __name__ == "__main__":
    main()
