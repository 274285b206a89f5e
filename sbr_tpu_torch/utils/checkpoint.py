"""Canonical parameter fingerprints and the tiled, checkpointed β×u sweep:
the port of ``sbr_tpu.utils.checkpoint``.

**Fingerprints** (`canonicalize`, `params_fingerprint`). The canonical
form is the reference's, character for character, so the port's
`ModelParams` (whose class and field names are the reference's)
fingerprints to the same sha256 hex as ``sbr_tpu``'s on the same values.

**The tiled sweep** (`run_tiled_grid`). A paper-resolution grid (the
5000×5000 Figure-5 heatmap) is one `beta_u_grid` call a tile, so device
memory stays bounded, and every finished tile persists so an interrupted
sweep resumes instead of restarting:

- one ``.npz`` a tile (atomic rename) holding ``max_aw``, ``xi`` and
  ``status``, with a ``.sha256`` sidecar, under a ``manifest.json`` whose
  sweep fingerprint (grid values, model, config, tile shape, dtype and the
  backend tag ``"torch"``) must match before any tile is adopted. A
  directory that ``sbr_tpu`` wrote is refused loudly: its floats differ
  from the port's by up to 1e-12;
- a tile's fields (and its health flags) come to the host in one
  device-to-host copy; the assembled grid lives on the host;
- a failed tile is retried under the unified retry policy
  (``SBR_RETRY_*``, a shared budget ``SBR_RETRY_BUDGET``); one that
  exhausts its attempts raises ``RuntimeError``;
- a corrupt tile is quarantined (``quarantine/`` beside it) and
  recomputed, never served;
- cells flagged divergent are re-run up the degrade ladder
  (`resilience.heal.repair_divergent`; ``SBR_HEAL=0`` or
  ``heal_divergent=False`` turns it off), and the manifest gains a
  ``repairs`` block;
- SIGTERM/SIGINT inside the tile loop remove partial temp files and held
  leases (`resilience.shutdown`);
- the fault points ``tile.compute``, ``tile.result``,
  ``checkpoint.save`` and ``checkpoint.load`` let a seeded
  ``SBR_FAULT_PLAN`` inject transient errors, NaN-poisoned results, torn
  files, hangs and preemptions (`resilience.faults`);
- with a cross-run `resilience.elastic.TileCache` (``SBR_TILE_CACHE_DIR``)
  a tile missing locally is looked up there first, and every computed
  tile is stored back.

``tile_shape="auto"`` goes through the memory planner of ``obs.mem``
(`resolve_tile_shape`), and before any tile runs the OOM preflight
(`_preflight_tile`) holds one full tile's measured footprint against the
card's capacity and fails closed. With telemetry on, every computed tile
lands a per-tile ``mem`` event. With ``SBR_FLIGHT`` on, `TileRunner.produce`
marks each tile's ``ckpt_load``, ``cache_io``, ``compute`` and
``ckpt_save`` on the flight recorder's ``sweeps`` stream; the tile bytes
are the same either way.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from sbr_tpu_torch.resilience import faults, heal, retry, shutdown

_FIELDS = ("max_aw", "xi", "status")
# The port's backend tag: it joins every sweep fingerprint and tile-cache
# key, so a port tile never answers for an sbr_tpu one, nor the other way.
BACKEND = "torch"


def canonicalize(obj) -> str:
    """Deterministic textual form of a parameter pytree — the canonical
    input to `params_fingerprint`.

    The same logical structure gives the same string across processes,
    interpreter restarts and dict insertion orders. Dataclasses render as
    ``TypeName(field=..., ...)`` with fields sorted by name; dicts sort by
    key; floats use Python's shortest round-trip ``repr``; numpy scalars
    and arrays hash dtype + raw bytes. Any other type raises
    ``TypeError``, a ``torch.Tensor`` included: a cache key must never
    depend on a ``repr`` that holds a memory address or a device.
    """
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        inner = ",".join(
            f"{name}={canonicalize(getattr(obj, name))}"
            for name in sorted(f.name for f in dataclasses.fields(obj))
        )
        return f"{type(obj).__name__}({inner})"
    if isinstance(obj, dict):
        items = sorted(obj.items(), key=lambda kv: canonicalize(kv[0]))
        return "{" + ",".join(f"{canonicalize(k)}:{canonicalize(v)}" for k, v in items) + "}"
    if isinstance(obj, (list, tuple)):
        return "[" + ",".join(canonicalize(v) for v in obj) + "]"
    if obj is None or isinstance(obj, (bool, int, str, bytes, float)):
        return repr(obj)
    if isinstance(obj, np.generic):
        return f"{obj.dtype.name}:{obj.item()!r}"
    if isinstance(obj, np.ndarray):
        return (
            f"ndarray{tuple(obj.shape)}:{obj.dtype.name}:"
            f"{np.ascontiguousarray(obj).tobytes().hex()}"
        )
    raise TypeError(
        f"canonicalize: unsupported type {type(obj).__name__} — extend the "
        "canonical form rather than falling back to repr (addresses would "
        "make fingerprints process-local)"
    )


def dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype ("float32", "float64"): the
    form the reference's fingerprints render a dtype in."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def sweep_dtype(dtype) -> torch.dtype:
    """The dtype a sweep computes in: float64 unless told otherwise, as in
    `beta_u_grid`."""
    return torch.float64 if dtype is None else dtype


def params_fingerprint(params) -> str:
    """Stable sha256 hex of a parameter pytree (`ModelParams`,
    `SolverConfig`, or any nesting of dataclasses, dicts, sequences and
    scalars); see `canonicalize` for the stability contract. The serving
    engine's result cache keys on it."""
    return hashlib.sha256(canonicalize(params).encode()).hexdigest()


def to_host(*tensors) -> list:
    """numpy copies of ``tensors`` through ONE device-to-host copy: their
    bytes are packed on the device, copied once and split on the host."""
    flat = [t.detach().contiguous().reshape(-1) for t in tensors]
    packed = torch.cat([t.view(torch.uint8) for t in flat]).cpu().numpy()
    out, start = [], 0
    for src, t in zip(tensors, flat):
        np_dtype = np.dtype(dtype_name(t.dtype))
        stop = start + t.numel() * np_dtype.itemsize
        out.append(packed[start:stop].view(np_dtype).reshape(tuple(src.shape)).copy())
        start = stop
    return out


def resolve_tile_shape(nb: int, nu: int, tile_shape, config=None, dtype=None,
                       mesh=None, device=None) -> Tuple[Tuple[int, int], Optional[dict]]:
    """Resolve ``tile_shape="auto"`` with the capacity planner of
    ``obs.mem``; an explicit ``(tb, tu)`` passes through (plan record None).

    For ``"auto"`` the planner fits a linear footprint model from two small
    measured probes (`grid_tile_footprint` at 8×8 and 16×16 on ``device``)
    and picks the largest power-of-two square tile that fits
    ``SBR_MEM_HEADROOM`` × the card's memory; with no capacity (the CPU) it
    skips the probes and falls back to (256, 256) clamped to the grid,
    verdict ``"skipped"``. The same capacity and grid give the same shape.
    The decision lands as a ``plan`` event and the manifest's
    ``memory.plan`` when telemetry is on. Under a ``mesh`` the candidate
    tiles must divide by its "b" and "u" axis sizes, and the model is
    budgeted per rank: a sharded tile puts 1/(n_b·n_u) of its cells on
    each."""
    if tile_shape != "auto":
        tb, tu = tile_shape
        return (int(tb), int(tu)), None
    from sbr_tpu_torch import obs
    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch.sweeps.baseline_sweeps import grid_tile_footprint

    if config is None:  # the sweep default, matching run_tiled_grid
        config = SolverConfig(refine_crossings=False)
    multiple = (1, 1)
    if mesh is not None:
        from sbr_tpu_torch.parallel.mesh import axis_size

        multiple = (axis_size(mesh, "b"), axis_size(mesh, "u"))
    shape, rec = obs.mem.plan_from_probes(
        int(nb), int(nu),
        lambda tb, tu: grid_tile_footprint(tb, tu, config=config, dtype=sweep_dtype(dtype),
                                           device=device),
        multiple_of=multiple,
        per_device_divisor=multiple[0] * multiple[1],
    )
    try:
        run = obs.current_run()
        if run is not None:
            run.log_plan(rec)
    except Exception:
        pass  # telemetry must never sink the planner
    return shape, rec


def _preflight_tile(nb, nu, tb, tu, config, dtype, device, plan=None,
                    mesh=None) -> Optional[dict]:
    """OOM preflight for the tiled sweep: one worst-case (full) tile's
    measured footprint against headroom × the card's memory, failing CLOSED
    (`MemoryPreflightError`) before any tile runs. Graceful skips, recorded
    and never fatal: ``SBR_MEM_PREFLIGHT=0``, no capacity (the CPU; no
    probe runs) and a mesh (reason "sharded": the unsharded measure would
    overstate a rank's share by the mesh size). When the planner already fitted this grid (``plan`` from
    ``tile_shape="auto"``), the verdict comes from its model rather than a
    third probe."""
    from sbr_tpu_torch.obs import mem as obs_mem

    if not obs_mem.preflight_enabled():
        return None
    tb_eff, tu_eff = min(tb, nb), min(tu, nu)
    label = f"tile[{tb_eff}x{tu_eff}]"
    capacity = obs_mem.device_capacity()
    if capacity is None or mesh is not None:
        return obs_mem.preflight(label, None, capacity=None,
                                 skip_reason="sharded" if mesh is not None else None)
    if plan is not None and plan.get("verdict") == "ok":
        fp = {
            "total_bytes": int(
                plan["model_fixed_bytes"]
                + plan["model_per_cell_bytes"] * (tb_eff * tu_eff)
            ),
            "source": "planner-model",
        }
    else:
        from sbr_tpu_torch.sweeps.baseline_sweeps import grid_tile_footprint

        fp = grid_tile_footprint(tb_eff, tu_eff, config=config, dtype=sweep_dtype(dtype),
                                 device=device)
    return obs_mem.check_preflight(obs_mem.preflight(label, fp, capacity=capacity))


def _tile_path(ckpt_dir: Path, bi: int, ui: int) -> Path:
    return ckpt_dir / f"tile_b{bi:05d}_u{ui:05d}.npz"


def tile_origins(n_b: int, n_u: int, tile_shape: Tuple[int, int]) -> list:
    """Tile origins in `run_tiled_grid`'s order: the one list the
    multi-host split and the elastic scheduler share."""
    tb, tu = tile_shape
    return [(bi, ui) for bi in range(0, n_b, tb) for ui in range(0, n_u, tu)]


def _sweep_fingerprint(beta_values, u_values, base, config, tile_shape, dtype) -> str:
    """Hash of everything that determines tile contents, so a checkpoint
    directory never serves results of another sweep: the reference's
    fields, with the dtype by name and the backend tag."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(np.asarray(beta_values, dtype=np.float64)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(u_values, dtype=np.float64)).tobytes())
    h.update(canonicalize((
        base, config, tuple(int(t) for t in tile_shape),
        dtype_name(sweep_dtype(dtype)), BACKEND,
    )).encode())
    return h.hexdigest()


def _write_json_atomic(directory: Path, path: Path, doc: dict) -> None:
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        f.write(json.dumps(doc))
    os.replace(tmp, path)


def _check_fingerprint(ckpt: Path, fingerprint: str, tile_shape=None) -> None:
    """Create or verify the checkpoint manifest. The creating process also
    records the tile shape, which a late-joining elastic host adopts
    (`resilience.elastic.recorded_tile_shape`)."""
    manifest = ckpt / "manifest.json"
    if manifest.exists():
        try:
            stored = json.loads(manifest.read_text()).get("fingerprint")
        except json.JSONDecodeError:
            # the write below is atomic, so this is corruption, not a race;
            # one short grace read before failing
            time.sleep(0.2)
            try:
                stored = json.loads(manifest.read_text()).get("fingerprint")
            except json.JSONDecodeError as err:
                raise ValueError(
                    f"Checkpoint dir {ckpt} has an unreadable manifest.json ({err}); "
                    "delete it (or use a fresh checkpoint_dir) and rerun."
                ) from err
        if stored != fingerprint:
            raise ValueError(
                f"Checkpoint dir {ckpt} holds tiles for a different sweep "
                "(grid values, model, config, tile shape, dtype or backend changed: "
                "a directory written by sbr_tpu is never adopted by sbr_tpu_torch). "
                "Use a fresh checkpoint_dir or delete the stale one."
            )
    elif any(ckpt.glob("tile_*.npz")):
        raise ValueError(
            f"Checkpoint dir {ckpt} contains tiles but no manifest.json; "
            "cannot confirm they belong to this sweep. Use a fresh "
            "checkpoint_dir or delete the unattributed tiles."
        )
    else:
        # atomic: several processes may start against one directory; losing
        # the race to a peer writing the same sweep writes the same bytes
        doc = {"fingerprint": fingerprint}
        if tile_shape is not None:
            doc["tile_shape"] = [int(t) for t in tile_shape]
        _write_json_atomic(ckpt, manifest, doc)


def _save_atomic(path: Path, arrays: dict) -> None:
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        # through the open handle: np.savez appends ".npz" to a bare path
        with shutdown.track_tmp(tmp):
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    # the sidecar after the rename: a crash between the two leaves a tile
    # with no sidecar ("legacy", trusted), never one whose sidecar describes
    # other bytes
    heal.write_sidecar(path)


def _load_tile_verified(path: Path, may_quarantine: bool = True) -> Optional[dict]:
    """Read a checkpointed tile, sha256-verified first: its field dict, or
    None for a corrupt or unreadable tile, which is quarantined only when
    ``may_quarantine`` (a non-owner pass leaves a peer's corrupt tile in
    place for the pass that recomputes it)."""
    try:
        faults.fire("checkpoint.load", target=path.name)
        if heal.verify_file(path) == "mismatch":
            if may_quarantine:
                heal.quarantine(path, reason="sha256-mismatch")
            return None
        with np.load(path) as data:
            return {f: data[f] for f in _FIELDS}
    except Exception as err:
        # a torn zip, rotted bytes on a sidecar-less tile, a missing field or
        # an injected load fault: corruption, to be recomputed
        if may_quarantine and path.exists():
            heal.quarantine(path, reason=f"unreadable: {err!r}")
        return None


def _poison_tile(rule, arrays: dict, flags: np.ndarray, tile_id: str) -> None:
    """Apply a ``nan`` injection: poison the first ``rule.cells`` cells of
    every float field and mark them NAN_OUTPUT-divergent."""
    from sbr_tpu_torch.diag.health import NAN_OUTPUT

    n = min(int(rule.cells), flags.size)
    for k in range(n):
        idx = np.unravel_index(k, flags.shape)
        for f in arrays:
            if np.issubdtype(arrays[f].dtype, np.floating):
                arrays[f][idx] = np.nan
        flags[idx] |= NAN_OUTPUT


def _record_repairs(ckpt: Path, repairs: list) -> None:
    """Fold this run's repairs into the manifest's ``repairs`` block (atomic
    rewrite). A manifest that cannot be read is left alone: rewriting it
    from scratch would lose the fingerprint."""
    manifest = ckpt / "manifest.json"
    try:
        doc = json.loads(manifest.read_text())
    except (OSError, json.JSONDecodeError):
        return
    doc.setdefault("repairs", []).extend(repairs)
    _write_json_atomic(ckpt, manifest, doc)


def _flight_recorder():
    """The process-wide flight recorder when ``SBR_FLIGHT`` is on, else
    None. The switch is read first, so the default path never imports
    `obs.flight`."""
    from sbr_tpu_torch import obs

    if not obs.switch_on("SBR_FLIGHT"):
        return None
    from sbr_tpu_torch.obs import flight

    return flight.shared()


class TileRunner:
    """Makes one tile of a sweep exist: from the local checkpoint, else
    the cross-run tile cache, else computed, with the retry policy, the
    fault points, the degrade ladder and the atomic save on the compute
    path. Shared by `run_tiled_grid`'s loop and the elastic scheduler,
    which calls `produce` once a claimed tile.

    ``counts`` tallies tiles by source ("local", "cache", "computed") and
    ``repairs`` gathers degrade-ladder reports. Build it with
    `tile_runner`, which resolves the defaults and checks the sweep
    fingerprint."""

    def __init__(
        self, beta_values, u_values, base, config, tile_shape, ckpt,
        dtype=None, policy=None, retry_budget=None, heal_divergent: bool = True,
        tile_cache=None, scenario_spec=None, device=None, mesh=None,
    ) -> None:
        self.beta_values = np.asarray(beta_values)
        self.u_values = np.asarray(u_values)
        self.base = base
        self.config = config
        # a scenario spec routes each tile through `scenario_grid` and joins
        # the fingerprint and every cache key (`_payload_base`)
        self.scenario_spec = scenario_spec
        self.tb, self.tu = (int(t) for t in tile_shape)
        self.nb, self.nu = len(self.beta_values), len(self.u_values)
        self.ckpt = Path(ckpt) if ckpt is not None else None
        self.dtype = dtype
        self.device = device
        self.mesh = mesh  # a (b, u) DeviceMesh: each tile is one sharded grid
        # under a mesh every rank computes every tile and only rank 0 writes
        # the checkpoint and the cache: two ranks' npz bytes differ in their
        # zip timestamps, and a sidecar must describe the bytes on disk
        self.writer = mesh is None or torch.distributed.get_rank() == 0
        self.policy = policy
        self.retry_budget = retry_budget
        self.heal_divergent = heal_divergent
        self.tile_cache = tile_cache
        self.repairs: list = []
        self.counts = {"local": 0, "cache": 0, "computed": 0}

    def slices(self, bi: int, ui: int) -> Tuple[slice, slice]:
        return (
            slice(bi, min(bi + self.tb, self.nb)),
            slice(ui, min(ui + self.tu, self.nu)),
        )

    def tile_id(self, bi: int, ui: int) -> str:
        return f"tile_b{bi:05d}_u{ui:05d}"

    def path(self, bi: int, ui: int) -> Optional[Path]:
        return _tile_path(self.ckpt, bi, ui) if self.ckpt is not None else None

    def load_local(self, bi: int, ui: int, may_quarantine: bool = True):
        """Verified read of the local checkpoint slot (None on a miss or a
        corrupt tile)."""
        path = self.path(bi, ui)
        if path is None or not path.exists():
            return None
        return _load_tile_verified(path, may_quarantine=may_quarantine)

    def _payload_base(self):
        """What the fingerprint and the cache keys hash as "the model": the
        bare params for plain sweeps, the (params, spec) pair for scenario
        sweeps, so a composed tile never collides with a plain one."""
        if self.scenario_spec is None:
            return self.base
        return (self.base, self.scenario_spec)

    def cache_key(self, bi: int, ui: int) -> Optional[str]:
        if self.tile_cache is None:
            return None
        bs, us = self.slices(bi, ui)
        return self.tile_cache.key(
            self._payload_base(), self.config, self.dtype,
            self.beta_values[bs], self.u_values[us],
        )

    def produce(self, bi: int, ui: int, skip_local: bool = False):
        """Make tile (bi, ui) exist locally; returns ``(source, arrays)``
        with source "local", "cache" or "computed". ``skip_local`` skips the
        local read when the caller already made it."""
        path = self.path(bi, ui)
        tid = self.tile_id(bi, ui)
        fl = _flight_recorder()
        if not skip_local:
            t0 = time.monotonic()
            cached = self.load_local(bi, ui)
            if fl is not None:
                fl.mark("sweeps", "ckpt_load", t0, time.monotonic(), tag=tid)
            if cached is not None:
                self.counts["local"] += 1
                return "local", cached
        key = self.cache_key(bi, ui)
        if key is not None:
            t0 = time.monotonic()
            arrays = self.tile_cache.load(key, tile=tid)
            if fl is not None:
                fl.mark("sweeps", "cache_io", t0, time.monotonic(), tag=tid)
            if arrays is not None:
                self.counts["cache"] += 1
                if path is not None and self.writer:
                    t0 = time.monotonic()
                    _save_atomic(path, arrays)
                    if fl is not None:
                        fl.mark("sweeps", "ckpt_save", t0, time.monotonic(), tag=tid)
                return "cache", arrays
        t0 = time.monotonic()
        arrays = self._compute(bi, ui)
        if fl is not None:
            fl.mark("sweeps", "compute", t0, time.monotonic(), tag=tid)
        self.counts["computed"] += 1
        if path is not None and self.writer:
            t0 = time.monotonic()
            _save_atomic(path, arrays)
            if fl is not None:
                fl.mark("sweeps", "ckpt_save", t0, time.monotonic(), tag=tid)
            # a ``corrupt`` rule tears the file after its save and sidecar
            # landed: the torn-write mode the check on load must catch
            inj = faults.fire("checkpoint.save", target=tid)
            if inj is not None and inj.kind == "corrupt":
                faults.corrupt_file(path)
        if key is not None and self.writer:
            # stored after the local save, from the same arrays. The meta
            # sidecar makes a plain tile's cells addressable for the serving
            # ladder; a scenario tile gets none (its cells answer another
            # pipeline, and `cell_tag` hashes bare params)
            meta = None
            if self.scenario_spec is None:
                from sbr_tpu_torch.resilience.elastic import tile_meta

                bs, us = self.slices(bi, ui)
                meta = tile_meta(self.base, self.config, self.dtype,
                                 self.beta_values[bs], self.u_values[us], key)
            t0 = time.monotonic()
            self.tile_cache.store(key, arrays, tile=tid, meta=meta)
            if fl is not None:
                fl.mark("sweeps", "cache_io", t0, time.monotonic(), tag=tid)
        return "computed", arrays

    def _grid(self, bs: slice, us: slice):
        if self.scenario_spec is not None:
            from sbr_tpu_torch.scenario import scenario_grid

            return scenario_grid(
                self.scenario_spec, self.beta_values[bs], self.u_values[us], self.base,
                config=self.config, dtype=self.dtype, device=self.device,
            )
        from sbr_tpu_torch.sweeps.baseline_sweeps import beta_u_grid

        return beta_u_grid(
            self.beta_values[bs], self.u_values[us], self.base,
            config=self.config, dtype=self.dtype, device=self.device, mesh=self.mesh,
        )

    def _compute(self, bi: int, ui: int) -> dict:
        """One tile's compute under the retry policy, with the fault,
        poison and degrade-ladder hooks."""
        from sbr_tpu_torch import obs

        bs, us = self.slices(bi, ui)
        tile_id = self.tile_id(bi, ui)
        tile_snap: dict = {}

        def compute_tile():
            faults.fire("tile.compute", target=tile_id)
            tile = self._grid(bs, us)
            leaves = [getattr(tile, f) for f in _FIELDS]
            if tile.health is not None:
                leaves.append(tile.health.flags)
            if obs.current_run() is not None:
                # while the tile's device tensors are still live
                tile_snap.clear()
                tile_snap.update(obs.mem.snapshot())
            host = to_host(*leaves)
            arrays = dict(zip(_FIELDS, host))
            tile_flags = (host[-1] if tile.health is not None
                          else np.zeros(arrays["status"].shape, np.int32))
            return arrays, tile_flags

        def observer(**rec):
            if rec.get("outcome") in ("retrying", "gave_up", "budget_exhausted"):
                print(
                    f"  tile ({bi},{ui}) attempt "
                    f"{rec.get('attempt')}/{rec.get('max_attempts')} "
                    f"{rec['outcome']}: {rec.get('error', '')}",
                    file=sys.stderr,
                )
            retry._default_observer(**rec)

        policy = self.policy if self.policy is not None else default_tile_policy()
        try:
            arrays, tile_flags = policy.call(
                compute_tile, scope=f"Tile ({bi},{ui})",
                budget=self.retry_budget, observer=observer,
            )
        except retry.RetryError as err:
            raise RuntimeError(str(err)) from err.__cause__

        # a ``nan`` rule poisons the computed arrays and flags: garbage
        # after a successful dispatch, which the ladder below must repair
        inj = faults.fire("tile.result", target=tile_id)
        if inj is not None and inj.kind == "nan":
            _poison_tile(inj, arrays, tile_flags, tile_id)

        # the ladder recomputes cells through the plain path: right for
        # plain sweeps and baseline-reducible specs (bit for bit the same
        # cells), meaningless for compositions, which keep their flags
        heal_ok = self.scenario_spec is None or self.scenario_spec.reduces_to() == "baseline"
        if self.heal_divergent and heal_ok and (tile_flags != 0).any():
            tile_report = heal.repair_divergent(
                self.beta_values[bs], self.u_values[us], self.base,
                self.config, self.dtype, arrays, tile_flags, scope=tile_id,
                device=self.device,
            )
            if tile_report:
                self.repairs.extend({"tile": [bi, ui], **r} for r in tile_report)

        # per-tile peak memory (obs.mem): one ``mem`` event with a ``tile``
        # field, folded into the manifest's tile table
        obs.log_tile_mem(tile_id, **tile_snap)
        return arrays


def default_tile_policy(max_retries: int = 2) -> retry.RetryPolicy:
    """The tile loop's retry policy (``SBR_RETRY_*`` overrides over
    ``max_retries`` extra attempts), shared by `run_tiled_grid` and the
    elastic scheduler."""
    return retry.policy_from_env(
        "SBR_RETRY",
        max_attempts=max_retries + 1,
        base_delay_s=1.0,
        multiplier=2.0,
        max_delay_s=60.0,
    )


def default_retry_budget(n_tiles: int) -> retry.RetryBudget:
    """The per-sweep shared retry budget (``SBR_RETRY_BUDGET`` override)."""
    budget_env = os.environ.get("SBR_RETRY_BUDGET", "").strip()
    return retry.RetryBudget(int(budget_env) if budget_env else max(16, n_tiles))


def tile_runner(
    beta_values,
    u_values,
    base,
    checkpoint_dir,
    config=None,
    tile_shape=(256, 256),
    dtype=None,
    max_retries: int = 2,
    heal_divergent: Optional[bool] = None,
    retry_budget: Optional[retry.RetryBudget] = None,
    tile_cache=None,
    scenario_spec=None,
    device=None,
    mesh=None,
) -> TileRunner:
    """A ready `TileRunner` for one sweep: the config and tile-shape
    defaults resolved as `run_tiled_grid` resolves them (so fingerprints
    agree), the checkpoint directory created and its fingerprint checked,
    and the OOM preflight run once (`_preflight_tile`). Tiles compute on
    ``device`` (default: the CUDA card; raises without one). With a
    (b, u) ``mesh`` every tile is one sharded `beta_u_grid` on the mesh's
    device (every rank runs the sweep alike); every tile, ragged edge tiles
    included, must divide by the mesh's "b" and "u" sizes, checked before
    anything is written."""
    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch.sweeps.baseline_sweeps import _mesh_device

    if mesh is not None and scenario_spec is not None:
        raise ValueError(
            "scenario_spec tiles compute through scenario_grid, which is "
            "single-device — mesh= is not supported on scenario sweeps"
        )
    if config is None:  # the sweep default: refinement off, as in beta_u_grid
        config = SolverConfig(refine_crossings=False)
    device = _mesh_device(mesh, device)
    beta_values = np.asarray(beta_values)
    u_values = np.asarray(u_values)
    nb, nu = len(beta_values), len(u_values)
    tile_shape, plan = resolve_tile_shape(nb, nu, tile_shape, config, dtype, mesh=mesh,
                                          device=device)
    if mesh is not None:
        from sbr_tpu_torch.parallel.mesh import axis_size

        tb, tu = tile_shape
        mb, mu = axis_size(mesh, "b"), axis_size(mesh, "u")
        tile_dims = ({min(tb, nb - bi) for bi in range(0, nb, tb)},
                     {min(tu, nu - ui) for ui in range(0, nu, tu)})
        if any(d % mb for d in tile_dims[0]) or any(d % mu for d in tile_dims[1]):
            raise ValueError(
                f"Tile sizes {sorted(tile_dims[0])}×{sorted(tile_dims[1])} must be "
                f"divisible by the mesh axes {mb}×{mu}; choose tile_shape/grid "
                "sizes that are multiples of the mesh shape."
            )
    if heal_divergent is None:
        heal_divergent = os.environ.get("SBR_HEAL", "").strip() != "0"
    ckpt = None
    fp_base = base if scenario_spec is None else (base, scenario_spec)
    if checkpoint_dir is not None:
        ckpt = Path(checkpoint_dir)
        ckpt.mkdir(parents=True, exist_ok=True)
        _check_fingerprint(
            ckpt,
            _sweep_fingerprint(beta_values, u_values, fp_base, config, tile_shape, dtype),
            tile_shape=tile_shape,
        )
    _preflight_tile(nb, nu, tile_shape[0], tile_shape[1], config, dtype, device, plan=plan,
                    mesh=mesh)
    if retry_budget is None:
        retry_budget = default_retry_budget(len(tile_origins(nb, nu, tile_shape)))
    return TileRunner(
        beta_values, u_values, base, config, tile_shape, ckpt,
        dtype=dtype, policy=default_tile_policy(max_retries),
        retry_budget=retry_budget, heal_divergent=heal_divergent,
        tile_cache=tile_cache, scenario_spec=scenario_spec, device=device, mesh=mesh,
    )


def run_tiled_grid(
    beta_values,
    u_values,
    base,
    config=None,
    tile_shape=(256, 256),
    checkpoint_dir: Optional[str] = None,
    mesh=None,
    dtype=None,
    max_retries: int = 2,
    verbose: bool = False,
    tile_owner=None,
    heal_divergent: Optional[bool] = None,
    retry_budget: Optional[retry.RetryBudget] = None,
    tile_cache=None,
    scenario_spec=None,
    device=None,
    report: Optional[dict] = None,
):
    """β×u grid in tiles with optional on-disk resume: the same cells as
    one `beta_u_grid` call over the whole grid (cells are independent),
    bit for bit, with device memory bounded by the tile and the
    checkpoint, retry and repair granularity of a tile (module docstring).

    ``config=None`` is not ``SolverConfig()``: None selects the sweep
    default (refinement off), and the config joins the fingerprint. Tiles
    compute on ``device`` (default: the CUDA card; raises without one) in
    ``dtype`` (default float64). The result is a `GridSweepResult` of host
    tensors in that dtype, without `health` (tiles do not store it).

    ``tile_owner(bi, ui) -> bool`` restricts computation to some tiles
    (the others stay NaN / -1 unless already on disk): the multi-host
    split's hook. Each tile runs under the retry policy (attempts =
    ``max_retries + 1``, a shared budget); a tile that exhausts them
    raises ``RuntimeError``. Corrupt tiles are quarantined and recomputed;
    divergent cells climb the degrade ladder unless ``heal_divergent``
    (env ``SBR_HEAL``) says otherwise. With ``tile_cache`` (default from
    ``SBR_TILE_CACHE_DIR``) missing tiles are looked up in the cross-run
    cache first and computed ones stored back. A dict passed as
    ``report`` receives the runner's tile ``counts`` and ``repairs``."""
    from sbr_tpu_torch.sweeps.baseline_sweeps import GridSweepResult

    if tile_cache is None:
        from sbr_tpu_torch.resilience.elastic import default_tile_cache

        tile_cache = default_tile_cache()

    runner = tile_runner(
        beta_values, u_values, base, checkpoint_dir, config=config,
        tile_shape=tile_shape, dtype=dtype, max_retries=max_retries,
        heal_divergent=heal_divergent, retry_budget=retry_budget,
        tile_cache=tile_cache, scenario_spec=scenario_spec, device=device, mesh=mesh,
    )
    nb, nu, tb, tu = runner.nb, runner.nu, runner.tb, runner.tu
    ckpt = runner.ckpt
    origins = tile_origins(nb, nu, (tb, tu))
    np_float = np.dtype(dtype_name(sweep_dtype(dtype)))
    out = {
        "max_aw": np.full((nb, nu), np.nan, np_float),
        "xi": np.full((nb, nu), np.nan, np_float),
        "status": np.full((nb, nu), -1, np.int32),
    }

    with shutdown.graceful_shutdown(label="tiled_grid"):
        for k, (bi, ui) in enumerate(origins):
            bs, us = runner.slices(bi, ui)
            owned = tile_owner is None or tile_owner(bi, ui)
            cached = runner.load_local(bi, ui, may_quarantine=owned)
            if cached is not None:
                for f in _FIELDS:
                    out[f][bs, us] = cached[f]
                runner.counts["local"] += 1
                continue
            if not owned:
                continue  # another process's tile: it lands on disk, not here
            _, arrays = runner.produce(bi, ui, skip_local=True)
            for f in _FIELDS:
                out[f][bs, us] = arrays[f]
            if verbose:
                print(f"  tile {k + 1}/{len(origins)} done")

    if verbose and runner.counts["local"]:
        print(f"  resumed {runner.counts['local']} tiles from {ckpt}")
    if ckpt is not None and runner.repairs:
        _record_repairs(ckpt, runner.repairs)
    if report is not None:
        report.update(counts=dict(runner.counts), repairs=list(runner.repairs))

    torch_dtype = sweep_dtype(dtype)
    return GridSweepResult(
        beta_values=torch.as_tensor(runner.beta_values, dtype=torch_dtype),
        u_values=torch.as_tensor(runner.u_values, dtype=torch_dtype),
        max_aw=torch.from_numpy(out["max_aw"]),
        xi=torch.from_numpy(out["xi"]),
        status=torch.from_numpy(out["status"]),
    )
