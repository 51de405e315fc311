"""Host-side simulation orchestration — the ``sph_simulation`` class.

API parity with the reference (libclsph/sph_simulation.h:8-28):
``load_settings(fluid_json, sim_json)``, ``simulate()``, ``parameters``,
``precomputed_terms``, ``pre_frame`` / ``save_frame`` / ``post_frame``
callbacks, ``write_intermediate_frames``, ``serialize``,
``current_scene``, ``initial_volume``.

The structural differences from the reference:

* the whole substep — including grid rebuild, sort and the adaptive-dt
  retry loop — is one jitted device program (engine/step.py), and when
  no per-substep callbacks are installed the *entire frame* substep
  loop runs on device (`frame_jit`), so device<->host traffic is one
  state fetch per saved frame instead of 4+ blocking reads per substep
  (sph_simulation.cpp:202/:259);
* frame export runs on a background thread exactly like the
  reference's ``std::thread`` overlap (sph_simulation.cpp:370-430);
* callbacks receive host NumPy views of the SoA state and may mutate
  them; returning True uploads the modified state back to the device —
  the same contract as executePreFrameOpperation
  (sph_simulation.cpp:730-768).
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import params as params_mod
from ..core.params import PrecomputedKernelValues, SimulationParameters
from ..core.state import ParticleState, init_state
from ..io import checkpoint as ckpt_mod
from ..io.async_saver import AsyncSaver
from ..ops import collisions as collisions_ops
from ..scene.scene import Scene
from ..utils.logging import get_logger
from .step import (
    FLAG_CAPACITY,
    FLAG_EXCHANGE,
    FLAG_GRID_DIM,
    StepConfig,
    frame_jit,
    substep_jit,
)

MAX_CAPACITY_RETRIES = 6

log = get_logger(__name__)

# host-side callback signatures:
#   pre_frame(arrays: dict, params, is_full_frame) -> bool (True = write back)
#   save_frame(arrays: dict, params) -> None
#   post_frame(arrays: dict, params, is_full_frame) -> bool
Callback = Callable[[dict, SimulationParameters, bool], bool]
SaveCallback = Callable[[dict, SimulationParameters], None]
# device-side view hook: device_view(state: ParticleState, params, True)
# receives the DEVICE-resident state each frame (no host fetch) — e.g.
# io/render.PointRenderer renders on the accelerator and only the
# pixels cross to the host (the device-side form of the reference's GL
# viewer, example/opengl.cpp:121-148)
DeviceView = Callable[[ParticleState, SimulationParameters, bool], None]


class SPHSimulation:
    def __init__(
        self,
        step_config: Optional[StepConfig] = None,
        mesh=None,
        exchange: str = "all_gather",
        halo_max: int = 0,
        halo_hops: int = 1,
    ):
        """``mesh``: a 1-D ``jax.sharding.Mesh`` to run multi-chip —
        the state is Morton-partitioned across devices and every
        substep runs under shard_map (parallel/sharded_step.py).
        ``exchange`` ('all_gather' | 'halo' | 'ring') / ``halo_max`` /
        ``halo_hops`` pick the neighbour-exchange strategy.
        """
        self.parameters: Optional[SimulationParameters] = None
        self.precomputed_terms: Optional[PrecomputedKernelValues] = None
        self.initial_volume: float = 0.0
        self.write_intermediate_frames = False
        self.serialize = False
        self.current_scene: Optional[Scene] = None
        self.pre_frame: Optional[Callback] = None
        self.save_frame: Optional[SaveCallback] = None
        self.post_frame: Optional[Callback] = None
        self.device_view: Optional[DeviceView] = None
        self.step_config = step_config or StepConfig()
        self.capacity_retries = 0
        self.checkpoint_path = ckpt_mod.DEFAULT_CHECKPOINT
        self.mesh = mesh
        self.exchange = exchange
        self.halo_max = halo_max
        self.halo_hops = halo_hops
        # filled by simulate()
        self.state: Optional[ParticleState] = None
        self.device_scene = None

    # ------------------------------------------------------------------
    def load_settings(self, fluid_file_name: str, parameters_file_name: str):
        """Parse the two JSON configs (sph_simulation.cpp:434-532)."""
        p = params_mod.load_parameters(fluid_file_name, parameters_file_name)
        self.parameters = p
        self.precomputed_terms = p.precomputed()
        self.initial_volume = p.initial_volume
        self.write_intermediate_frames = p.write_all_frames
        self.serialize = p.serialize
        return p

    def load_scene(self, filename: str, scenes_dir: str = "scenes"):
        """scene::load with threshold 2h (example/particles.cpp:67)."""
        assert self.parameters is not None, "call load_settings first"
        self.current_scene = Scene.load(
            filename, self.parameters.h * 2.0, scenes_dir=scenes_dir
        )
        return self.current_scene

    # ------------------------------------------------------------------
    def init_particles(self) -> ParticleState:
        """Checkpoint resume or cube lattice (sph_simulation.cpp:52-98)."""
        p = self.parameters
        arrays = None
        try:
            arrays = ckpt_mod.load_checkpoint(self.checkpoint_path, p)
        except ValueError as e:
            raise RuntimeError(str(e))
        if arrays is not None:
            log.info("resuming from %s", self.checkpoint_path)
            return ParticleState(
                position=jnp.asarray(arrays["position"]),
                velocity=jnp.asarray(arrays["velocity"]),
                intermediate_velocity=jnp.asarray(arrays["intermediate_velocity"]),
                acceleration=jnp.asarray(arrays["acceleration"]),
                density=jnp.asarray(arrays["density"]),
                pressure=jnp.asarray(arrays["pressure"]),
                grid_index=jnp.asarray(arrays["grid_index"]),
            )
        side = self.initial_volume ** (1.0 / 3.0)
        log.info(
            "volume: %g side_length: %g", self.initial_volume, side
        )
        return init_state(p)

    # ------------------------------------------------------------------
    def _fetch(self, state: ParticleState) -> dict:
        return ckpt_mod.state_to_arrays(jax.block_until_ready(state))

    def _upload(self, arrays: dict) -> ParticleState:
        return ParticleState(
            position=jnp.asarray(arrays["position"], jnp.float32),
            velocity=jnp.asarray(arrays["velocity"], jnp.float32),
            intermediate_velocity=jnp.asarray(
                arrays["intermediate_velocity"], jnp.float32
            ),
            acceleration=jnp.asarray(arrays["acceleration"], jnp.float32),
            density=jnp.asarray(arrays["density"], jnp.float32),
            pressure=jnp.asarray(arrays["pressure"], jnp.float32),
            grid_index=jnp.asarray(arrays["grid_index"], jnp.uint32),
        )

    def _grow_capacity(self):
        """Neighbour-capacity autotune: a substep reported that a
        static candidate/cell capacity truncated real neighbours.
        Double it and recompile (new StepConfig = new jit cache entry);
        the caller re-runs the frame from its saved pre-frame state, so
        no corrupted step is ever kept."""
        cfg = self.step_config
        self.capacity_retries += 1
        if self.capacity_retries > MAX_CAPACITY_RETRIES:
            raise RuntimeError(
                "neighbour capacity keeps overflowing; the particle "
                "distribution is degenerate (all particles in one cell?)"
            )
        if cfg.neighbor_impl == "exact":
            cfg = dataclasses.replace(cfg, cell_capacity=cfg.cell_capacity * 2)
            grown = {"cell_capacity": cfg.cell_capacity}
        else:
            cfg = dataclasses.replace(cfg, max_candidates=cfg.max_candidates * 2)
            grown = {"max_candidates": cfg.max_candidates}
        log.warning(
            "neighbour capacity overflow - growing %s and re-running frame",
            grown,
        )
        self.step_config = cfg

    def _needs_rerun(self, flags) -> bool:
        """Interpret the substep's status bitfield. Returns True when
        the frame must be re-run (neighbour capacity grown); raises on
        unrecoverable conditions."""
        f = int(flags)
        if f & FLAG_GRID_DIM:
            raise RuntimeError(
                "simulation grid too large: a grid axis reached the "
                "1024-cell Morton limit (reference aborts here too, "
                "sph_simulation.cpp:722-724) or outgrew a reduced "
                "LIBCLSPH_TPU_SORT_BITS key width; check dt / fluid "
                "stiffness, or raise the sort bits"
            )
        rerun = False
        if f & FLAG_EXCHANGE:
            # ring exchange under-reach is a capacity condition like any
            # other: grow halo_hops and re-run the frame (r5; previously
            # raised). Hop budgets saturate at full ring coverage
            # ((S+1)//2 per direction) where the reach check can no
            # longer fire — long flow-through runs under static shard
            # ownership decay toward that bound by design
            # (parallel/sharded_step.py ownership note).
            n_shards = self.mesh.devices.size if self.mesh is not None else 1
            max_hops = (n_shards + 1) // 2
            if self.halo_hops >= max_hops:
                raise RuntimeError(
                    "ring halo exchange out of reach at full ring "
                    "coverage — this indicates an exchange bug, not a "
                    "capacity shortfall"
                )
            # no capacity_retries charge: growth is already bounded by
            # max_hops (at most log2(S) growths ever)
            self.halo_hops = min(max_hops, max(self.halo_hops * 2, 1))
            log.warning(
                "ring exchange under-reach - growing halo_hops to %d "
                "and re-running frame", self.halo_hops,
            )
            rerun = True
        if f & FLAG_CAPACITY:
            self._grow_capacity()
            rerun = True
        return rerun

    def _save(self, saver: AsyncSaver, arrays: dict):
        p = self.parameters
        save_cb = self.save_frame
        ckpt = self.checkpoint_path if self.serialize else None

        def run():
            save_cb(arrays, p)
            if ckpt:
                ckpt_mod.save_checkpoint(ckpt, arrays, p)

        saver.submit(run)

    def _save_deferred(self, saver: AsyncSaver, state, fetch):
        """Like _save, but the device->host fetch itself runs on the
        saver thread, overlapping the transfer with the next frame's
        dispatch (the functional step never mutates ``state``'s
        buffers, so the snapshot stays valid; frame_jit deliberately
        has no donate_argnums)."""
        p = self.parameters
        save_cb = self.save_frame
        ckpt = self.checkpoint_path if self.serialize else None

        def run():
            arrays = fetch(state)
            save_cb(arrays, p)
            if ckpt:
                ckpt_mod.save_checkpoint(ckpt, arrays, p)

        saver.submit(run)

    # ------------------------------------------------------------------
    def _simulate_sharded(self) -> float:
        """Multi-chip frame loop: substeps run under shard_map over
        ``self.mesh``.

        Mirrors the single-chip loop's two paths:
        * fast path (no ``write_intermediate_frames``) — the whole
          frame substep loop runs on device (`make_sharded_frame`, the
          shard_map twin of `frame_jit`): the host fetches ONE timeleft
          scalar per dispatch instead of one dt per substep;
        * slow path — per-substep dispatch honouring per-substep
          ``pre_frame`` / ``save_frame`` / ``post_frame`` callbacks
          (sph_simulation.cpp:378-409 semantics), like the single-chip
          engine.
        """
        from ..parallel.mesh import particle_sharding
        from ..parallel.sharded_step import (
            make_sharded_frame,
            make_sharded_substep,
            pad_for_mesh,
        )

        # sort_interval runs under the mesh too: shard ownership is
        # static (particles never migrate between shards — pad_for_mesh
        # partitions once and the halo machinery covers cross-shard
        # neighbours), so skipped local sorts are exactly as safe as on
        # a single device (parallel/sharded_step._local_substep).
        p = self.parameters
        t_start = _time.perf_counter()
        self.device_scene = collisions_ops.build_device_scene(self.current_scene)
        saver = AsyncSaver()

        if self.exchange in ("halo", "ring") and not self.halo_max:
            # default surface budget: every local block may be surface
            # (the CLI applies the same substitution; halo_max=0 would
            # otherwise overflow the surface set on every substep)
            chunk = self.mesh.devices.size * self.step_config.block_size
            padded = -(-p.particles_count // chunk) * chunk
            self.halo_max = padded // chunk

        state = self.init_particles()
        state = pad_for_mesh(state, p, self.mesh, self.step_config)
        sharding = particle_sharding(self.mesh)
        state = jax.tree.map(lambda a: jax.device_put(a, sharding), state)

        def build(maker):
            return maker(
                self.mesh, p, self.device_scene, self.step_config,
                exchange=self.exchange, halo_max=self.halo_max,
                halo_hops=self.halo_hops,
            )

        def fetch_real(st) -> dict:
            arrays = ckpt_mod.state_to_arrays(jax.block_until_ready(st))
            real = np.abs(arrays["position"]).max(axis=1) < 1.0e30
            return {k: v[real] for k, v in arrays.items()}

        def reupload(arrays):
            # re-partition the mutated state across the mesh
            st = self._upload(arrays)
            st = pad_for_mesh(st, p, self.mesh, self.step_config)
            return jax.tree.map(lambda a: jax.device_put(a, sharding), st)

        timeperframe = p.frame_time
        dt = jnp.float32(timeperframe * p.simulation_scale)
        sim_time = 0.0
        current_frame = 2

        fast_path = not self.write_intermediate_frames
        frame_fn = build(make_sharded_frame) if fast_path else None
        step = build(make_sharded_substep) if not fast_path else None

        if self.device_view:  # initial frame (like the initial save)
            self.device_view(state, p, True)
        if self.save_frame:
            self._save(saver, fetch_real(state))

        while sim_time < p.simulation_time:
            log.info("Simulating frame %d (%gs)", current_frame, sim_time)
            if fast_path and self.pre_frame:
                arrays = fetch_real(state)
                if self.pre_frame(arrays, p, True):
                    state = reupload(arrays)

            if fast_path:
                while True:
                    st_try, dt_try = state, dt
                    timeleft = jnp.float32(timeperframe)
                    rerun = False
                    while float(timeleft) > 0.0:
                        st_try, dt_try, timeleft, flags = frame_fn(
                            st_try, dt_try, timeleft
                        )
                        if self._needs_rerun(flags):
                            frame_fn = build(make_sharded_frame)
                            rerun = True
                            break
                    if not rerun:
                        state, dt = st_try, dt_try
                        break
            else:
                timeleft = timeperframe
                while timeleft > 0.0:
                    if self.pre_frame:
                        arrays = fetch_real(state)
                        if self.pre_frame(arrays, p, False):
                            state = reupload(arrays)
                    # substep-granular retry: the jitted step never
                    # commits on overflow (state input unchanged)
                    while True:
                        new_state, dt_dev, flags = step(state, dt)
                        if not self._needs_rerun(flags):
                            state = new_state
                            break
                        step = build(make_sharded_substep)
                    dt_f = float(dt_dev)
                    timeleft -= dt_f
                    dt = jnp.float32(
                        min(dt_f, timeleft) if timeleft < dt_f else dt_f
                    )
                    log.debug("frame time remaining: %g", timeleft)
                    if self.save_frame:
                        self._save_deferred(saver, state, fetch_real)
                    if self.post_frame:
                        arrays = fetch_real(state)
                        if self.post_frame(arrays, p, False):
                            state = reupload(arrays)

            sim_time += timeperframe
            current_frame += 1
            if self.device_view:
                self.device_view(state, p, True)
            if self.save_frame:
                # the saver thread fetches + owns its own snapshot
                self._save_deferred(saver, state, fetch_real)
            if self.post_frame:
                arrays = fetch_real(state)
                if self.post_frame(arrays, p, True):
                    state = reupload(arrays)

        saver.close()
        self.state = state
        return _time.perf_counter() - t_start

    # ------------------------------------------------------------------
    def simulate(self) -> float:
        """The frame loop (sph_simulation.cpp:265-432). Returns the
        simulated wall-clock seconds."""
        assert self.parameters is not None, "call load_settings first"
        if self.mesh is not None:
            return self._simulate_sharded()
        p = self.parameters

        t_start = _time.perf_counter()
        self.device_scene = collisions_ops.build_device_scene(self.current_scene)
        state = self.init_particles()
        saver = AsyncSaver()

        timeperframe = p.frame_time
        dt = jnp.float32(timeperframe * p.simulation_scale)
        sim_time = 0.0
        current_frame = 2  # reference starts at 2 (sph_simulation.cpp:365)

        arrays = None  # host cache of the current state
        if self.device_view:  # initial frame (like the initial save)
            self.device_view(state, p, True)
        if self.save_frame:
            self._save(saver, self._fetch(state))

        fast_path = not self.write_intermediate_frames

        while sim_time < p.simulation_time:
            log.info("Simulating frame %d (%gs)", current_frame, sim_time)

            if fast_path and self.pre_frame:
                if arrays is None:
                    arrays = self._fetch(state)
                if self.pre_frame(arrays, p, True):
                    state = self._upload(arrays)

            if fast_path:
                # whole frame on device — substeps_per_dispatch steps
                # per dispatch (bounded against dt-floor blowups); one
                # scalar (timeleft) read back per dispatch
                while True:
                    st_try, dt_try = state, dt
                    timeleft = jnp.float32(p.frame_time)
                    rerun = False
                    while float(timeleft) > 0.0:
                        st_try, dt_try, timeleft, flags = frame_jit(
                            st_try, dt_try, timeleft, p,
                            self.device_scene, self.step_config,
                        )
                        if self._needs_rerun(flags):
                            rerun = True
                            break
                    if not rerun:
                        state, dt = st_try, dt_try
                        break
                arrays = None
            else:
                timeleft = timeperframe
                while timeleft > 0.0:
                    if self.pre_frame:
                        if arrays is None:
                            arrays = self._fetch(state)
                        if self.pre_frame(arrays, p, False):
                            state = self._upload(arrays)
                    while True:
                        out = substep_jit(
                            state, dt, p, self.device_scene, self.step_config
                        )
                        new_state, dt_dev, flags = out[:3]
                        if not self._needs_rerun(flags):
                            state = new_state
                            break
                    arrays = None
                    dt_f = float(dt_dev)
                    timeleft -= dt_f
                    dt = jnp.float32(min(dt_f, timeleft) if timeleft < dt_f else dt_f)
                    log.debug("frame time remaining: %g", timeleft)
                    if self.save_frame:
                        self._save_deferred(saver, state, self._fetch)
                        # the saver thread fetches its own snapshot
                        arrays = None
                    if self.post_frame:
                        if arrays is None:
                            arrays = self._fetch(state)
                        if self.post_frame(arrays, p, False):
                            state = self._upload(arrays)
                            arrays = None

            sim_time += timeperframe
            current_frame += 1

            if self.device_view:
                self.device_view(state, p, True)
            if fast_path and self.save_frame:
                # the saver thread fetches + owns its own snapshot
                self._save_deferred(saver, state, self._fetch)
                arrays = None
            if fast_path and self.post_frame:
                if arrays is None:
                    arrays = self._fetch(state)
                if self.post_frame(arrays, p, True):
                    state = self._upload(arrays)
                    arrays = None

        saver.close()
        self.state = state
        return _time.perf_counter() - t_start
