"""High-level simulation driver.

The counterpart of ``owPhysicsFluidSimulator`` + the headless half of
``owWorldSimulation`` (`/root/reference/src/owPhysicsFluidSimulator.h:14-21`,
`src/owWorldSimulation.cpp:961-1017`): owns device state, steps the physics,
exposes the same state getters (positions, velocities, densities, pressures,
elastic connections, membranes), drives trajectory dumps every
``dump_interval`` steps (reference ``iter_step = 10``), and adds what the
reference lacks: true checkpoint/resume and muscle-signal override.

Stepping is chunked: ``run(n)`` executes ceil(n / chunk) fused device scans
with no host synchronization inside a chunk.
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np
import jax

from ..config import SimParams

logger = logging.getLogger("sph_jax")
from ..constants import MUSCLE_COUNT
from ..core.state import FluidState
from ..core.step import diagnostics, multi_step, simulation_step
from ..ops import pair_kernels as pk
from ..scene.scene import Scene
from ..scene.io import TrajectoryDumper
from .checkpoint import load_checkpoint, save_checkpoint
from .timing import StepTimer


def resolve_auto_engine(platform: str, layout) -> str:
    """engine="auto" resolution for a JAX backend. On the GPU, the
    wall-compact fastw engine wherever it can run (it needs elastic-only
    spring anchors; on the H100 it measured no slower than fast from the
    44%-wall worm down to the 11%-wall dam-break, PERF.md), else fast. On
    the CPU the pair kernels only run interpreted, so use the exact
    engine."""
    if pk.interpret_for(platform):
        return "exact"
    return "fastw" if layout.springs_elastic_only else "fast"


class Simulator:
    def __init__(
        self,
        scene: Scene,
        params: SimParams | None = None,
        dump_dir: str | None = None,
        dump_interval: int = 10,
        log=None,
        engine: str = "auto",
        adaptive_resort: bool = False,
        drift_threshold_h: float = 0.25,
        distributed_resort: bool = False,
        fast_config: dict | None = None,
        async_io: bool = True,
    ):
        """engine: "auto" (default) = :func:`resolve_auto_engine` for the
        default JAX backend (fastw or fast on a GPU, exact on the CPU,
        where the pair kernels only run interpreted); "exact" =
        neighbor-list engine (reference 32-cap semantics — the opt-in for
        validation work); "fast" = blocked pair-kernel engine (all pairs
        within h, see core/fast.py);
        "halo" = the fast engine sharded over all visible devices with
        ppermute halo exchange (parallel/halo.py; pads the scene to the
        device grid); "fastw" = the wall-compact fast engine
        (core/fastw.py): static boundary walls leave the hot carry and
        only a thin live shell of them is recomputed per step —
        preferred on wall-heavy scenes (44% of the worm is frozen wall);
        requires elastic-only spring anchors.

        adaptive_resort (fast/halo engines): resort EARLY when the
        in-scan window-staleness bound crosses ``drift_threshold_h``
        (units of h) — after each chunk the simulator reads the chunk's
        pair-approach bound (2x the summed per-step max displacement / h)
        and halves the resort period while it exceeds the threshold,
        doubling it back (with hysteresis) when dynamics calm down.
        Costs one host sync per chunk; the period moves between
        resort_every, /2 and /4 (at most 3 compiled graphs).

        distributed_resort (halo engine): use the O(cells) distributed
        resort instead of the replicated all-gather one
        (parallel/halo.py); surfaces ``resort_overflow`` through
        check_overflow.

        fast_config (fast/fastw/halo engines): keyword overrides
        forwarded to ``compute_fast_config`` / ``compute_fastw_config``
        (block/ccol/ccol_c/resort_every).

        async_io (default True): trajectory frames and non-blocking
        checkpoints are written by a side IO thread (runtime/async_io.py,
        SURVEY §5) — the device->host transfer and the host-side
        formatting overlap the next chunk's dispatch. ``flush()`` drains
        pending writes; ``step``/``save`` re-raise any IO error from the
        worker. False = reference-style synchronous writes."""
        self.params = params or SimParams()
        fck = dict(fast_config or {})
        if engine == "auto":
            engine = resolve_auto_engine(jax.default_backend(),
                                         scene.layout())
        if engine == "halo":
            from ..core.fast import compute_fast_config
            from ..parallel import make_mesh, pad_scene_to_devices

            self._mesh = make_mesh()
            ndev = self._mesh.devices.size
            # blocks must divide across devices
            self._fast_cfg = compute_fast_config(
                scene.pos, self.params, block_multiple=ndev, **fck
            )
            scene = pad_scene_to_devices(
                scene, ndev * self._fast_cfg.block
            )
            self._fast_cfg = compute_fast_config(
                scene.pos, self.params, block_multiple=ndev, **fck
            )
        self.scene = scene
        self.layout = scene.layout()
        self.state, self.springs, self.membranes = scene.device_state()
        self.engine = engine
        self._fast_runs = {}
        if engine == "halo":
            from ..parallel import shard_state

            self.state = shard_state(self.state, self._mesh)
            self._fast_chunk = max(1, self._fast_cfg.resort_every)
            self._distributed_resort = distributed_resort
        elif engine == "fast":
            from ..core.fast import compute_fast_config

            self._fast_cfg = compute_fast_config(scene.pos, self.params,
                                                 **fck)
            # one compiled graph covers any multiple of this chunk; align
            # with the resort period so each chunk re-sorts exactly once
            self._fast_chunk = max(1, self._fast_cfg.resort_every)
        elif engine == "fastw":
            from ..core.fastw import (compute_fastw_config,
                                      precompute_wall_static)

            self._fast_cfg = compute_fastw_config(
                scene.pos, self.params, self.layout, ptype=scene.ptype,
                **fck)
            # walls never move: hoist their sort + mutual density sums
            # out of every resort
            self._wall_static = precompute_wall_static(
                scene.pos, scene.normal, self.params, self.layout,
                self._fast_cfg)
            self._fast_chunk = max(1, self._fast_cfg.resort_every)
        elif engine == "exact":
            # Scene-derived cell capacity: the default silently truncates
            # neighbor candidates on dense scenes (reference failure mode,
            # sphFluid.cl:169) — measure the real occupancy instead.
            from ..core.grid import measured_cell_capacity

            cap = measured_cell_capacity(scene.pos, self.params)
            if cap > self.params.cell_capacity:
                self.params = dataclasses.replace(
                    self.params, cell_capacity=cap
                )
        else:
            raise ValueError(f"unknown engine {engine!r}")
        self._adaptive = adaptive_resort and engine in ("fast", "fastw",
                                                        "halo")
        self._drift_threshold_h = float(drift_threshold_h)
        if self._adaptive:
            base = self._fast_chunk
            # descending period ladder: resort_every, /2, /4 (>= 1)
            self._chunk_levels = sorted(
                {max(1, base >> k) for k in range(3)}, reverse=True
            )
        self.timer = StepTimer(log=log)
        self._dumper = (
            TrajectoryDumper(dump_dir, scene) if dump_dir else None
        )
        self.dump_interval = dump_interval
        self._writer = None
        if async_io:
            from .async_io import AsyncWriter

            self._writer = AsyncWriter()
        if self._dumper:
            if self._writer:
                self._writer.submit(self._dumper.append, self.state.pos)
            else:
                self._dumper.append(np.asarray(self.state.pos))

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------

    @property
    def step_count(self) -> int:
        return int(self.state.step)

    def _fast_run_for(self, n: int):
        if n not in self._fast_runs:
            if self.engine == "halo":
                from ..parallel import (
                    make_halo_fast_multi_step, measure_halo_pad,
                    measure_migration_pad)

                # scene-measured halo band (clamped to per-device rows;
                # halo_overflow still surfaces any resort-time violation)
                per_dev = (
                    self._fast_cfg.n_blocks
                    // self._mesh.devices.size * self._fast_cfg.block
                )
                pad = min(
                    measure_halo_pad(
                        self.scene.pos, self.params, self._fast_cfg),
                    per_dev,
                )
                halo_run = make_halo_fast_multi_step(
                    self._mesh, self.params, self.layout, self._fast_cfg, n,
                    halo_pad=pad,
                    distributed_resort=self._distributed_resort,
                    mig_cap=min(
                        measure_migration_pad(
                            self.scene.pos, self.params, self._fast_cfg),
                        per_dev,
                    ) if self._distributed_resort else None,
                )

                def run(state, springs, membranes, _h=halo_run):
                    out, diag = _h(state, springs, membranes)
                    # accumulate across chunk calls (a transient overflow
                    # in an early chunk must not be masked by a clean
                    # final chunk); lazy device max — no host sync here
                    prev = getattr(self, "_halo_overflow", 0)
                    self._halo_overflow = jax.numpy.maximum(
                        jax.numpy.asarray(diag["halo_overflow"]),
                        jax.numpy.asarray(prev),
                    )
                    if "resort_overflow" in diag:
                        prev_r = getattr(self, "_resort_overflow", 0)
                        self._resort_overflow = jax.numpy.maximum(
                            jax.numpy.asarray(diag["resort_overflow"]),
                            jax.numpy.asarray(prev_r),
                        )
                    self._track_drift(diag["window_drift"])
                    return out

                self._fast_runs[n] = run
            elif self.engine == "fastw":
                from ..core.fastw import make_fastw_multi_step

                fw_run = make_fastw_multi_step(
                    self.params, self.layout, self._fast_cfg, n,
                    return_diag=True, wall_static=self._wall_static,
                )

                def run(state, springs, membranes, _f=fw_run):
                    out, diag = _f(state, springs, membranes)
                    # lazy device max across chunk calls, no host sync
                    # (mirrors the halo engine's overflow accumulators)
                    self._shell_overflow = jax.numpy.maximum(
                        jax.numpy.asarray(diag["shell_overflow"]),
                        jax.numpy.asarray(
                            getattr(self, "_shell_overflow", 0)))
                    self._track_drift(diag["window_drift"])
                    return out

                self._fast_runs[n] = run
            else:
                from ..core.fast import make_fast_multi_step

                fast_run = make_fast_multi_step(
                    self.params, self.layout, self._fast_cfg, n,
                    return_drift=True,
                )

                def run(state, springs, membranes, _f=fast_run):
                    out, drift = _f(state, springs, membranes)
                    self._track_drift(drift)
                    return out

                self._fast_runs[n] = run
        return self._fast_runs[n]

    def _track_drift(self, drift):
        """Window-staleness bound, accumulated IN the compiled scan:
        per resort period, the sum of per-step max Euclidean
        displacements — bounding intra-period excursions, not just the
        net per-axis motion. Lazy device max over chunks, no host sync."""
        prev = getattr(self, "_window_drift", 0.0)
        self._window_drift = jax.numpy.maximum(
            jax.numpy.asarray(drift),
            jax.numpy.asarray(prev, jax.numpy.asarray(drift).dtype),
        )
        self._last_drift = drift  # lazy; adaptive resort syncs it

    def _run(self, n: int):
        if self.engine in ("fast", "fastw", "halo"):
            # compile at most two graphs (a chunk-sized scan + a
            # single-step) regardless of how n varies across calls;
            # adaptive mode moves along a 3-level period ladder (<= 4
            # graphs total)
            state = self.state
            remaining = n
            while remaining > 0:
                chunk = self._fast_chunk
                size = chunk if remaining >= chunk else 1
                state = self._fast_run_for(size)(
                    state, self.springs, self.membranes
                )
                remaining -= size
                if self._adaptive and size > 1:
                    # one scalar host sync per chunk: the chunk's in-scan
                    # pair-approach bound decides the NEXT period
                    ratio = 2.0 * float(
                        jax.numpy.asarray(self._last_drift)
                    ) / self.params.h
                    lv = self._chunk_levels
                    i = lv.index(chunk) if chunk in lv else 0
                    if ratio > self._drift_threshold_h and i + 1 < len(lv):
                        self._fast_chunk = lv[i + 1]
                        logger.info(
                            "adaptive resort: drift bound %.2f h > %.2f — "
                            "period %d -> %d", ratio,
                            self._drift_threshold_h, chunk, lv[i + 1],
                        )
                    elif (ratio < 0.4 * self._drift_threshold_h
                          and i > 0):
                        # hysteresis: doubling the period roughly doubles
                        # the bound; only step up when even 2x stays
                        # clearly under the threshold
                        self._fast_chunk = lv[i - 1]
            if self.engine == "halo":
                # particle LOSS must be loud at the run site, not only in
                # a pollable diagnostic: the distributed
                # resort drops rows that overrun its fixed-capacity
                # migration buffers, and clipped halo windows drop pairs.
                # One scalar host sync per user-level run; check_overflow
                # still reports (and resets) the same accumulators.
                ovf_r = int(jax.numpy.asarray(
                    getattr(self, "_resort_overflow", 0)))
                if ovf_r:
                    logger.error(
                        "distributed resort DROPPED %d particle(s) by step"
                        " %d (migration buffers overran mig_cap) — mass is"
                        " lost; raise mig_cap (see measure_migration_pad) "
                        "or lower resort_every", ovf_r, int(state.step),
                    )
                ovf_h = int(jax.numpy.asarray(
                    getattr(self, "_halo_overflow", 0)))
                if ovf_h:
                    logger.error(
                        "halo windows clipped %d row(s) by step %d — "
                        "pairs are being dropped; raise halo_pad (see "
                        "measure_halo_pad)", ovf_h, int(state.step),
                    )
            if self.engine == "fastw":
                # shell overflow = moving-wall pairs DROPPED (wrong
                # forces near the wall with no other signal) — loud at
                # the run site, same rule as halo particle loss
                ovf_s = int(jax.numpy.asarray(
                    getattr(self, "_shell_overflow", 0)))
                if ovf_s:
                    logger.error(
                        "fastw shell overflowed by %d wall row(s) by step"
                        " %d — moving-wall pairs are being dropped; raise"
                        " shell_margin/dilate in compute_fastw_config",
                        ovf_s, int(state.step),
                    )
            return state
        return multi_step(self.state, self.springs, self.membranes,
                          self.params, self.layout, n)

    def step(self, n: int = 1) -> None:
        """Advance n steps; dumps trajectory frames at the dump interval.

        At every dump boundary (where positions are already materialized on
        the host) capacity overflow is checked and logged — the reference
        truncates silently (sphFluid.cl:169); we surface it.
        """
        if self._dumper is None:
            self.state = self._run(n)
            return
        done = 0
        while done < n:
            upto = min(
                n - done,
                self.dump_interval - self.step_count % self.dump_interval,
            )
            self.state = self._run(upto)
            done += upto
            if self.step_count % self.dump_interval == 0:
                if self._writer is not None:
                    # frame write (transfer + text formatting) overlaps
                    # the next chunk's dispatch on the IO thread
                    self._writer.submit(self._dumper.append, self.state.pos)
                    self.check_overflow()
                else:
                    pos = np.asarray(self.state.pos)
                    self._dumper.append(pos)
                    self.check_overflow(pos)

    def check_overflow(self, pos: np.ndarray | None = None) -> dict:
        """Host-side capacity diagnostics at the current positions; warns on
        any nonzero count (silent truncation corrupts physics with no other
        signal). The exact engine has cell capacities; the fast engines
        walk exact interaction windows with a dynamic tile count, and
        report only the capacities they do have (fastw shell, halo band,
        distributed-resort migration). Returns a dict of counts."""
        from ..core.grid import max_cell_occupancy

        if pos is None:
            pos = np.asarray(self.state.pos)
        out = {}
        out["cell_overflow"] = (
            max(0, max_cell_occupancy(pos, self.params)
                - self.params.cell_capacity)
            if self.engine == "exact" else 0
        )
        if self.engine == "halo":
            # read-and-reset: the accumulator covers the span since the
            # last check
            out["halo_overflow"] = int(
                getattr(self, "_halo_overflow", 0)
            )
            self._halo_overflow = 0
            if self._distributed_resort:
                out["resort_overflow"] = int(
                    getattr(self, "_resort_overflow", 0)
                )
                self._resort_overflow = 0
        if self.engine == "fastw":
            # read-and-reset (in-jit accumulated): dropped moving-wall
            # pairs
            out["shell_overflow"] = int(getattr(self, "_shell_overflow", 0))
            self._shell_overflow = 0
        bad = {k: v for k, v in out.items() if v > 0}
        if bad:
            logger.warning(
                "capacity overflow at step %d: %s — neighbor candidates are "
                "being dropped; rebuild with larger capacities",
                self.step_count, bad,
            )
        if self.engine in ("fast", "fastw", "halo"):
            # worst per-resort-period PAIR-APPROACH bound since the last
            # check, in units of h: 2x the in-scan sum of per-step max
            # Euclidean displacements (two particles can converge at twice
            # the single-particle bound, and the sum covers intra-period
            # excursions). Beyond ~h/4 the stale-window deviation stops
            # being negligible — shorten resort_every.
            drift = float(getattr(self, "_window_drift", 0.0))
            self._window_drift = 0.0
            out["window_drift_h"] = 2.0 * drift / self.params.h
            if out["window_drift_h"] > 0.25:
                logger.warning(
                    "window drift %.2f h within a resort period at step %d "
                    "— marginal pairs may be missed; lower resort_every "
                    "for these dynamics",
                    out["window_drift_h"], self.step_count,
                )
        return out

    def step_blocking(self, n: int = 1) -> float:
        """Step and wait for the device; returns wall-clock milliseconds."""
        self.timer.refresh()
        self.step(n)
        jax.block_until_ready(self.state)
        return self.timer.elapsed_ms

    # ------------------------------------------------------------------
    # state API (reference getters, owPhysicsFluidSimulator.h:14-21)
    # ------------------------------------------------------------------

    def get_position(self) -> np.ndarray:
        return np.asarray(self.state.pos)

    def get_velocity(self) -> np.ndarray:
        return np.asarray(self.state.vel)

    def get_density(self) -> np.ndarray:
        return np.asarray(diagnostics(self.state, self.params)["rho"])

    def get_pressure(self) -> np.ndarray:
        return np.asarray(diagnostics(self.state, self.params)["pressure"])

    def get_diagnostics(self) -> dict:
        out = {
            k: np.asarray(v)
            for k, v in diagnostics(self.state, self.params).items()
        }
        return out

    def get_elastic_connections(self):
        return (
            np.asarray(self.springs.idx),
            np.asarray(self.springs.rest),
            np.asarray(self.springs.muscle),
        )

    def get_membranes(self) -> np.ndarray:
        return np.asarray(self.membranes.tris)

    def get_muscle_activation(self) -> np.ndarray:
        return np.asarray(self.state.muscle_activation)

    def set_muscle_activation(self, values) -> None:
        """Manual override (the reference's interactive '1'..'9' keys,
        `owWorldSimulation.cpp:771-844`). Only meaningful when the scene's
        wave model is off, otherwise the next step overwrites it."""
        act = np.zeros(MUSCLE_COUNT, np.float32)
        values = np.asarray(values, np.float32).ravel()
        act[: len(values)] = values
        self.state = FluidState(
            pos=self.state.pos,
            vel=self.state.vel,
            ptype=self.state.ptype,
            normal=self.state.normal,
            muscle_activation=jax.numpy.asarray(act),
            step=self.state.step,
        )

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------

    def save(self, path: str, wait: bool = True) -> None:
        """Checkpoint the full state (atomic write). ``wait=False`` hands
        the save to the async IO thread (requires ``async_io=True``):
        the device->host transfer and npz compression overlap further
        stepping; call :meth:`flush` before reading the file."""
        if not wait and self._writer is not None:
            self._writer.submit(
                save_checkpoint, path, self.state, self.springs,
                self.membranes, color=self.scene.color,
            )
            return
        save_checkpoint(
            path, self.state, self.springs, self.membranes,
            color=self.scene.color,
        )

    def flush(self) -> None:
        """Drain pending async trajectory/checkpoint writes (re-raises
        any IO error from the worker thread)."""
        if self._writer is not None:
            self._writer.flush()

    def restore(self, path: str) -> None:
        state, springs, membranes, color = load_checkpoint(path)
        self.state, self.springs, self.membranes = state, springs, membranes
        if color is not None:
            self.scene.color = color
