"""Smoke run of the SPH main path on one NVIDIA GPU, in one process.

    python chip_smoke.py               # phases 1-5 on one card
    python chip_smoke.py --four-cards  # the sharded path on 4 cards only

Phases (each one that fails raises, so the exit code is non-zero):

1. Device: JAX must report a GPU; prints its kind, the device count and
   the card's name and power limit (nvidia-smi, in a child process).
2. The reference's deployment: ``cli.main`` on water + cube at the
   64,000 particles of simulation_properties/default.json, cut to 5
   frames; the .geo frames carry all particles, every particle stays
   inside the cube scene's bounds, densities sit near rest density.
3. The bench's width: bench.py's substep loop at 1M particles on the
   cube, with no status flag raised; prints ms/substep with the card.
4. The fused kernels against their references: the XLA tiles passes at
   1M (lattice) and 64k (a few frames in), and the float64 oracle of
   experiments/fidelity_64k.py at 64k; prints the substep's
   ``memory_analysis()``.
5. The ``gpu``-marked tests (pytest, in this process).

``--four-cards`` runs only the sharded path (``--mesh 4``, all_gather
exchange) from a 1M cube state for a few substeps and compares it with
the single-card substeps from the same state.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "chip_smoke")

# phase-4 tolerances. Both sides are float32 and differ only in the
# order of summation; the force combine cancels, so acceleration gets
# the looser bound. The float64 oracle is held to the 1e-4 parity
# budget.
DENSITY_RMS, DENSITY_MAX, ACCEL_RMS = 2e-5, 1e-4, 1e-4
ORACLE_RMS = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_rms(got, ref) -> float:
    import numpy as np

    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.sqrt(np.sum((got - ref) ** 2) / np.sum(ref**2)))


def rel_max(got, ref) -> float:
    import numpy as np

    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------- phase 1
def phase_device() -> dict:
    import jax

    from libclsph_tpu.platform import gpu_card

    dev = jax.devices()[0]
    log(f"device: {dev.device_kind} x {len(jax.devices())}")
    card = gpu_card()
    check(card is not None, "nvidia-smi gave no card")
    log(card)
    return dict(platform=dev.platform, kind=dev.device_kind,
                count=len(jax.devices()), card=card)


# ---------------------------------------------------------------- phase 2
def phase_reference_deployment(out_dir: str, particles: int = 64000,
                               frames: int = 5) -> dict:
    """``cli.main`` in this process on a copy of the reference's inputs
    under ``out_dir`` (passed as --root)."""
    import numpy as np

    from libclsph_tpu import cli

    shutil.rmtree(out_dir, ignore_errors=True)
    for sub in ("fluid_properties", "scenes", "simulation_properties"):
        os.makedirs(os.path.join(out_dir, sub))
    shutil.copy(os.path.join(REPO, "fluid_properties", "water.json"),
                os.path.join(out_dir, "fluid_properties"))
    shutil.copy(os.path.join(REPO, "scenes", "cube.obj"),
                os.path.join(out_dir, "scenes"))
    with open(os.path.join(REPO, "simulation_properties", "default.json")) as f:
        sim = json.load(f)
    # half a frame short of `frames`: the frame loop runs while the
    # accumulated time is below it, so float rounding cannot add one
    sim.update(particles_count=particles, serialize=True,
               simulation_time=(frames - 0.5) / sim["target_fps"])
    with open(os.path.join(out_dir, "simulation_properties", "smoke.json"),
              "w") as f:
        json.dump(sim, f)

    # the engine checkpoints to ./last_frame.npz: run inside out_dir
    with contextlib.chdir(out_dir):
        code = cli.main(["water", "smoke", "cube", "smoke_", "--root", "."])
    check(code == 0, f"cli.main returned {code}")

    geo = sorted(glob.glob(os.path.join(out_dir, "smoke_frames", "*.geo")))
    check(len(geo) == frames + 1, f"{len(geo)} frames, want {frames + 1}")
    for path in geo:
        with open(path) as f:
            f.readline()
            head = f.readline().split()
        check(head[:2] == ["NPoints", str(particles)], f"{path}: {head}")

    last = np.load(os.path.join(out_dir, "last_frame.npz"))
    pos, rho = last["position"], last["density"]
    check(np.isfinite(pos).all() and np.isfinite(rho).all(), "non-finite state")
    check(not stray_particles(pos, out_dir, "smoke"), "particles left the scene")
    with open(os.path.join(REPO, "fluid_properties", "water.json")) as f:
        rho0 = json.load(f)["fluid_density"]
    p90 = float(np.quantile(rho, 0.9))
    check(0.9 * rho0 < p90 < 1.1 * rho0, f"90th-percentile density {p90}")
    check(float(rho.min()) > 0.0, "non-positive density")
    rec = dict(frames=len(geo), particles=particles, density_p90=p90,
               density_min=float(rho.min()), density_max=float(rho.max()))
    log(f"reference deployment: {json.dumps(rec)}")
    return rec


def stray_particles(pos, root: str, sim_name: str) -> int:
    """Particles outside the cube scene after a short run: inside the
    solid box of scenes/cube.obj by more than h, below its bottom, or
    more than 2h sideways or above the lattice they started in."""
    import numpy as np

    from libclsph_tpu.core.params import load_parameters
    from libclsph_tpu.core.state import init_lattice_positions

    params = load_parameters(
        os.path.join(root, "fluid_properties", "water.json"),
        os.path.join(root, "simulation_properties", sim_name + ".json"),
    )
    h = params.h
    with open(os.path.join(root, "scenes", "cube.obj")) as f:
        verts = np.asarray([[float(x) for x in line.split()[1:4]]
                            for line in f if line.startswith("v ")])
    box_lo, box_hi = verts.min(axis=0), verts.max(axis=0)
    start = init_lattice_positions(params)
    lo = np.minimum(start.min(axis=0), box_lo) - 2 * h
    hi = start.max(axis=0) + 2 * h
    outside = np.any((pos < lo) | (pos > hi), axis=1)
    in_solid = np.all((pos > box_lo + h) & (pos < box_hi - h), axis=1)
    n = int((outside | in_solid).sum())
    if n:
        log(f"{n} stray particles (outside [{lo}, {hi}] or inside the cube)")
    return n


# ---------------------------------------------------------------- phase 3
def phase_bench_width(card: str | None, particles: int = 1_000_000,
                      steps: int = 10) -> dict:
    import bench

    res = bench.run(["--n", str(particles), "--steps", str(steps),
                     "--json-only"])
    d = res["detail"]
    check(d["timed_flags"] == 0, f"timed_flags {d['timed_flags']}")
    check(d["final_dt"] > 0.0, f"final dt {d['final_dt']}")
    log(f"bench: {d['ms_per_step']:.3f} ms/substep at {particles} particles "
        f"({d['impl']}, {d['device_kind']}; {card})")
    return res


# ---------------------------------------------------------------- phase 4
def sorted_blocks(state, params, block_size: int, max_candidates: int):
    """The substep's view before its density pass: padded, Morton
    sorted, blocked, with candidate lists."""
    import jax
    import jax.numpy as jnp

    from libclsph_tpu.ops import grid as grid_ops
    from libclsph_tpu.ops import tiles as tiles_ops

    n = params.particles_count
    grid = grid_ops.compute_bounds(state.position, params)
    codes = grid_ops.locate_in_grid(state.position, grid)
    npad = tiles_ops.padded_count(n, block_size)
    far = grid.max_point + 1000.0 * params.h
    pos = jnp.concatenate(
        [state.position, jnp.broadcast_to(far, (npad - n, 3))]
    )
    vel = jnp.concatenate([state.velocity, jnp.zeros((npad - n, 3))])
    codes = jnp.concatenate(
        [codes, jnp.full((npad - n,), tiles_ops.SENTINEL_CODE, jnp.uint32)]
    )
    order = jnp.argsort(codes, stable=True)
    pos, vel, real = pos[order], vel[order], order < n
    blocked = tiles_ops.make_blocked(
        pos, vel, jnp.zeros(npad), jnp.zeros(npad), real, block_size
    )
    bmin, bmax = tiles_ops.split_block_bounds(blocked.position, blocked.real)
    cand, count, ovf = jax.jit(
        tiles_ops.candidate_blocks_auto, static_argnums=(2, 3)
    )(bmin, bmax, float(params.h), max_candidates)
    check(not bool(ovf), "candidate capacity overflow")
    return blocked, real, cand, count


def kernel_vs_tiles(state, params, label, interpret=False,
                    max_candidates=96, block_size=128):
    """Fused kernels vs the XLA tiles passes on one state. Returns the
    kernel's (blocked fields, real mask, density, accel)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from libclsph_tpu.ops import interactions
    from libclsph_tpu.ops import tiles as tiles_ops
    from libclsph_tpu.ops.pallas import neighbor_gpu

    terms = params.precomputed()
    blocked, real, cand, count = sorted_blocks(
        state, params, block_size, max_candidates
    )
    cfg = tiles_ops.TileConfig(block_size=block_size,
                               max_candidates=max_candidates)

    @jax.jit
    def kernels(blocked, real, cand, count):
        pack = neighbor_gpu.pack_density(blocked)
        rho = neighbor_gpu.fused_density(pack, pack, cand, count, params,
                                         terms, interpret=interpret)
        rho = jnp.where(real, rho, params.fluid_density)
        p = jnp.where(real, interactions.tait_pressure(rho, params), 0.0)
        blocked = blocked._replace(density=rho.reshape(blocked.density.shape),
                                   pressure=p.reshape(blocked.pressure.shape))
        fpack = neighbor_gpu.pack_forces(blocked, params.particle_mass)
        acc = neighbor_gpu.fused_forces(fpack, rho, fpack, cand, count,
                                        params, terms, interpret=interpret)
        return blocked, rho, acc

    @jax.jit
    def tiles(blocked, cand, count):
        with jax.default_matmul_precision("highest"):
            return (
                tiles_ops.density_pass(blocked, cand, count, params, terms, cfg),
                tiles_ops.force_pass(blocked, cand, count, params, terms, cfg),
            )

    blocked, rho, acc = kernels(blocked, real, cand, count)
    # the tiles force pass reads the kernel's density (blocked), so the
    # force comparison isolates the force pass
    rho_t, acc_t = tiles(blocked, cand, count)
    m = np.asarray(real)
    rec = dict(
        density_rms=rel_rms(np.asarray(rho)[m], np.asarray(rho_t)[m]),
        density_max=rel_max(np.asarray(rho)[m], np.asarray(rho_t)[m]),
        accel_rms=rel_rms(np.asarray(acc)[m], np.asarray(acc_t)[m]),
    )
    log(f"kernel vs tiles {label}: {json.dumps(rec)}")
    check(rec["density_rms"] <= DENSITY_RMS, f"{label} density rms")
    check(rec["density_max"] <= DENSITY_MAX, f"{label} density max")
    check(rec["accel_rms"] <= ACCEL_RMS, f"{label} accel rms")
    return blocked, m, np.asarray(rho), np.asarray(acc), rec


def phase_kernels(interpret: bool = False, big: int = 1_000_000,
                  small: int = 64000, settle_frames: int = 3,
                  oracle_rows: int = 512) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import build_params
    from experiments.fidelity_64k import oracle_accel, oracle_density
    from libclsph_tpu.core.state import init_state
    from libclsph_tpu.engine.step import StepConfig, frame_jit, substep_jit

    out = {}
    # the bench's dam-break lattice at full width
    params = build_params(big)
    _, _, _, _, out["big"] = kernel_vs_tiles(
        init_state(params), params, f"{big}", interpret
    )

    # the reference's width a few frames into the dam-break
    params = build_params(small)
    cfg = StepConfig(max_candidates=96)
    state, dt = init_state(params), jnp.float32(params.max_dt)
    for _ in range(settle_frames):
        tl = jnp.float32(params.frame_time)
        while float(tl) > 0.0:
            state, dt, tl, flags = frame_jit(state, dt, tl, params, None, cfg)
            check(not int(flags), f"flags {int(flags)} while settling")
    blocked, m, rho, acc, out["small"] = kernel_vs_tiles(
        state, params, f"{small} after {settle_frames} frames", interpret
    )
    pos = np.asarray(blocked.position).reshape(-1, 3)[m]
    vel = np.asarray(blocked.velocity).reshape(-1, 3)[m]
    rho_o = oracle_density(pos, params)
    rows = np.sort(np.random.default_rng(7).choice(
        len(pos), min(oracle_rows, len(pos)), replace=False))
    acc_o, nlen = oracle_accel(pos, vel, rho_o, params, rows)
    # the surface-tension switch is discontinuous at its threshold: a
    # row within 0.1% of it may take the other branch in float32
    thr = params.surface_tension_threshold
    keep = np.abs(nlen - thr) > 1e-3 * thr
    rec = dict(density_rms=rel_rms(rho[m], rho_o),
               accel_rms=rel_rms(acc[m][rows][keep], acc_o[keep]),
               accel_rows=int(keep.sum()))
    log(f"kernel vs float64 oracle {small}: {json.dumps(rec)}")
    check(rec["density_rms"] <= ORACLE_RMS, "oracle density rms")
    check(rec["accel_rms"] <= ORACLE_RMS, "oracle accel rms")
    out["oracle"] = rec

    if not interpret:
        params = build_params(big)
        mem = substep_jit.lower(
            init_state(params), jnp.float32(params.max_dt), params, None,
            StepConfig(max_candidates=96, sort_interval=4),
        ).compile().memory_analysis()
        log(f"substep memory_analysis at {big}: {mem}")
        out["memory_analysis"] = str(mem)
    return out


# ---------------------------------------------------------------- phase 5
def phase_gpu_tests() -> int:
    import pytest

    code = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                        os.path.join(REPO, "tests")])
    check(code == 0, f"gpu-marked tests exit {code}")
    return int(code)


# ------------------------------------------------------------ four cards
def phase_four_cards(particles: int = 1_000_000, substeps: int = 3,
                     cards: int = 4) -> dict:
    """The sharded substep (all_gather exchange) against the single-card
    substep, both from the same state for ``substeps`` substeps."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import build_params
    from libclsph_tpu.core.state import init_state
    from libclsph_tpu.engine.step import StepConfig, substep_jit
    from libclsph_tpu.ops import collisions as collisions_ops
    from libclsph_tpu.parallel.mesh import make_mesh, particle_sharding
    from libclsph_tpu.parallel.sharded_step import (
        make_sharded_substep, pad_for_mesh,
    )
    from libclsph_tpu.scene.scene import Scene

    check(len(jax.devices()) >= cards, f"{len(jax.devices())} devices")
    params = build_params(particles)
    scene = collisions_ops.build_device_scene(
        Scene.load("cube.obj", params.h * 2,
                   scenes_dir=os.path.join(REPO, "scenes"))
    )
    cfg = StepConfig(max_candidates=96)
    state0, dt0 = init_state(params), jnp.float32(params.max_dt)

    single, dt = state0, dt0
    for _ in range(substeps):
        single, dt, flags = substep_jit(single, dt, params, scene, cfg)
        check(not int(flags), f"single-card flags {int(flags)}")

    mesh = make_mesh(jax.devices()[:cards])
    step = make_sharded_substep(mesh, params, scene, cfg)
    sharded = pad_for_mesh(state0, params, mesh, cfg)
    sharded = jax.tree.map(
        lambda a: jax.device_put(a, particle_sharding(mesh)), sharded
    )
    dt = dt0
    for _ in range(substeps):
        sharded, dt, flags = step(sharded, dt)
        check(not int(flags), f"sharded flags {int(flags)}")

    from scipy.spatial import cKDTree

    def real_rows(st):
        pos = np.asarray(st.position, np.float64)
        keep = np.abs(pos).max(axis=1) < 1.0e30
        return (pos[keep], np.asarray(st.density)[keep],
                np.asarray(st.acceleration)[keep])

    p1, r1, a1 = real_rows(single)
    p4, r4, a4 = real_rows(sharded)
    check(len(p4) == particles, f"{len(p4)} real rows after sharding")
    # both orders are Morton orders of different partitions: match each
    # sharded particle to its nearest single-card particle (the runs
    # differ by summation order only, far below the lattice spacing)
    _, match = cKDTree(p1).query(p4)
    check(len(np.unique(match)) == particles, "particle matching not 1:1")
    p1, r1, a1 = p1[match], r1[match], a1[match]
    rec = dict(
        cards=cards, particles=particles, substeps=substeps,
        position_max_abs=float(np.max(np.abs(p4 - p1))),
        density_rms=rel_rms(r4, r1), density_max=rel_max(r4, r1),
        accel_rms=rel_rms(a4, a1),
    )
    log(f"sharded vs single card: {json.dumps(rec)}")
    check(rec["density_rms"] <= DENSITY_RMS, "sharded density rms")
    check(rec["density_max"] <= DENSITY_MAX, "sharded density max")
    check(rec["accel_rms"] <= ACCEL_RMS, "sharded accel rms")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on 4 cards")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"no GPU: JAX's first device is {jax.devices()[0].platform}",
              file=sys.stderr)
        return 1
    from libclsph_tpu import platform

    platform.enable_compile_cache()
    dev = phase_device()
    if args.four_cards:
        phase_four_cards()
    else:
        phase_reference_deployment(OUT)
        phase_bench_width(dev["card"])
        phase_kernels()
        phase_gpu_tests()
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cuda"
    sys.exit(main())
