"""Fault-tolerant serving: snapshot/restore and sync-journal crash recovery
for the fleet LoD service. Port of `repro.serve.recovery`, with its formats
(`SNAPSHOT_FORMAT`, `journal.jsonl`, `snapshots/step_<seq>`), so that each
package restores the other's snapshots and replays the other's journals.

A killed `LodService` loses every client's temporal and manager state and
forces a cold full-tree resync: the bandwidth cliff that Δcut streaming
exists to avoid. This module puts `repro_torch.checkpoint.manager` under
the service:

  * `snapshot_service` / `restore_service` — the whole service: the
    `ServiceState` tree (slots, temporal and manager state, paging debt,
    sync counters), the host control-plane mirrors (slot occupancy, client
    ids, cameras, foveation τs, Δ-payload tenancy), the bitrate
    controller's state (targets, allowances, τ scales and the previous
    sync's measured bytes, the one-sync-delayed feedback it replays from),
    and the static config in the manifest extras. A restored service
    replays bit for bit against one that never stopped.
  * `SyncJournal` + `replay` + `RecoveryManager` — an append-only,
    CRC-framed journal of each mutating call's inputs (camera updates,
    admits and evicts, bandwidth re-tiers, NACKed rows) and a snapshot
    every K syncs: a crash between snapshots recovers by restoring the
    newest intact snapshot and re-executing the journal's tail. `recover`
    walks the snapshots newest first, so a torn newest one falls back to
    the one before.

Every injected fault (a save killed mid-write, a truncated leaf file, a
corrupt manifest, a torn or corrupt journal, a mismatched tree) ends in a
restore from an earlier consistent point or a typed `RecoveryError`, never
in a silently diverged fleet.

Under a serving mesh (`repro_torch.sharding.fleet`) every rank makes the
same calls: a snapshot gathers every client block, rank 0 writes the files
(those of the meshless service byte for byte, apart from the manifest's
`"mesh"`, which holds the mesh's signature) while the others wait for it
and raise if it failed, and only rank 0 appends to the journal. `restore_service` and
`recover` take a target `mesh=` beside `device=`: every rank reads the
whole snapshot and keeps its block (reshard-on-load), whatever mesh, or
none, the snapshot was taken under; the saved signature is reported
(`RecoveryManager.saved_mesh`).

What the port has no counterpart for: the reference records its sweep
implementation and its Pallas `interpret` flag. The port has one pooled
sweep (K6; the reference's two sweeps give the same bits), so it writes
the reference's defaults (`"sweep_impl": "xla"`, `"interpret": true`),
which restore there on any host, and reads any of them. Restored tensors
go to the card unless the caller asks for the CPU.

Journal records hold Python ints, floats, strings and None only: the CRC
covers their canonical JSON, which must be the same bytes in both
packages. A bad line with nothing valid after it is a torn tail (the append
a crash interrupted) and is truncated away; a bad line followed by valid
records is corruption in mid-file, a `RecoveryError`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import manager as ckpt
from repro_torch.core.lod_tree import LodTree
from repro_torch.core.pipeline import SessionConfig
from repro_torch.device import DeviceLike
from repro_torch.serve import fleet as flt
from repro_torch.serve.lod_service import AdmissionDenied, LodService, ServiceStats
from repro_torch.sharding import fleet as shd

SNAPSHOT_FORMAT = "nebula-fleet-snapshot/1"
JOURNAL_NAME = "journal.jsonl"
SNAPSHOT_DIRNAME = "snapshots"
# what the reference records for a meshless service with its default sweep
_SWEEP_IMPLS = ("xla", "pallas")
_WRITTEN_SWEEP_IMPL = "xla"
_WRITTEN_INTERPRET = True


class RecoveryError(RuntimeError):
    """A snapshot or journal cannot be used for a faithful restore: torn or
    truncated files, corrupt manifests, fingerprint or config mismatches,
    journal holes, or a replay that diverges. The typed alternative to
    serving diverged state."""


# ---------------------------------------------------------------------------
# snapshot / restore
# ---------------------------------------------------------------------------


def tree_fingerprint(tree: LodTree) -> Dict[str, Any]:
    """Identity of the shared city tree a snapshot was taken against: its
    sizes and a float64 sum over the Gaussian means. numpy sums the host
    copy, in the reference's order (restores compare the dict exactly, and
    another summation order would differ in the last bits)."""
    m = tree.meta
    mu = tree.gaussians.mu.detach().contiguous().cpu().numpy()
    return {
        "n_pad": int(tree.n_pad), "T": int(m.T), "Ns": int(m.Ns),
        "S": int(m.S), "n_real": int(m.n_real),
        "mu_sum": float(mu.sum(dtype=np.float64)),
    }


def _writes(mesh) -> bool:
    """Whether this rank writes the shared files: rank 0 of a mesh, or the
    meshless service's one process."""
    return mesh is None or dist.get_rank() == 0


def _on_writer(mesh, fn):
    """Run `fn` on the writing rank and return what it returns. Under a mesh
    the other ranks wait for it and learn how it went: when it raised, it
    raises the same error on the writer and a `RecoveryError` naming it on
    every other rank, so no rank carries on as if it had worked."""
    out, err = None, None
    if _writes(mesh):
        try:
            out = fn()
        except Exception as e:  # re-raised below, on this rank and the others
            err = e
    if mesh is not None:
        failed = shd.broadcast_object(None if err is None else f"{type(err).__name__}: {err}")
        if err is None and failed is not None:
            raise RecoveryError(f"rank 0 failed: {failed}")
    if err is not None:
        raise err
    return out


def _host_mirrors(service: LodService) -> Dict[str, np.ndarray]:
    """The service's host control-plane state as a flat dict of arrays (the
    `host` half of the snapshot). `taus` is stored dense (cfg.tau where
    unset; the `has_taus` extra restores the None); the previous sync's
    measured bytes ride along for the controller's feedback."""
    cap = service.capacity
    taus = (np.asarray(service.taus, np.float32) if service.taus is not None
            else np.full((cap,), service.cfg.tau, np.float32))
    if service._last_stats is not None:
        last_bytes = service.gather_slots(
            service._last_stats.sync_bytes).detach().cpu().numpy().astype(np.float32)
    else:
        last_bytes = np.zeros((cap,), np.float32)
    return {
        "active": np.asarray(service._active, bool),
        "allowance": np.asarray(service._allowance, np.int64),
        "bw_target": np.asarray(service._bw_target, np.float64),
        "client_ids": np.asarray(service._client_ids, np.int64),
        "delta_ids": np.asarray(service._delta_ids, np.int64),
        "last_sync_bytes": last_bytes,
        "slot_cams": np.asarray(service._slot_cams, np.float32),
        "stats_fresh": np.asarray(service._stats_fresh, bool),
        "tau_scale": np.asarray(service._tau_scale, np.float32),
        "taus": taus,
    }


def _host_like(capacity: int) -> Dict[str, np.ndarray]:
    """Shape and dtype skeleton of `_host_mirrors` for `ckpt.restore`."""
    return {
        "active": np.zeros((capacity,), bool),
        "allowance": np.zeros((capacity,), np.int64),
        "bw_target": np.zeros((capacity,), np.float64),
        "client_ids": np.zeros((capacity,), np.int64),
        "delta_ids": np.zeros((capacity,), np.int64),
        "last_sync_bytes": np.zeros((capacity,), np.float32),
        "slot_cams": np.zeros((capacity, 3), np.float32),
        "stats_fresh": np.zeros((capacity,), bool),
        "tau_scale": np.zeros((capacity,), np.float32),
        "taus": np.zeros((capacity,), np.float32),
    }


def snapshot_service(service: LodService, directory: str, step: int = 0, *,
                     journal_seq: int = 0,
                     scheduler_state: Optional[Dict[str, Any]] = None) -> str:
    """Atomically write `service` as checkpoint `step_<step>` under
    `directory` (`checkpoint.manager.save`: a kill mid-write leaves a `.tmp`
    leftover, never a half checkpoint). Returns the final path.

    The tree is {"state": ServiceState, "host": mirrors}; the session
    config, the scheduler mode, the budgets, the capacity, the shared tree's
    fingerprint and `journal_seq` (the journal records before this
    snapshot) ride in the manifest extras, with `scheduler_state`
    (`DeadlineScheduler.state_dict()`) if given. The Δ payload is a
    per-sync artifact and is not saved; its tenancy vector is, so a
    restored service refuses stale decode requests.

    Under a mesh every rank calls it: the client blocks are gathered, rank 0
    writes, and the others wait for it and raise if it failed."""
    extras = {
        "format": SNAPSHOT_FORMAT,
        "capacity": int(service.capacity),
        "next_id": int(service._next_id),
        "has_taus": service.taus is not None,
        "has_last_stats": service._last_stats is not None,
        "journal_seq": int(journal_seq),
        "cfg": dataclasses.asdict(service.cfg),
        "service": {
            "focal": float(service.focal),
            "mode": service.mode,
            "sweep_impl": _WRITTEN_SWEEP_IMPL,
            "interpret": _WRITTEN_INTERPRET,
            "dedup": bool(service.dedup),
            "page_size": int(service.page_size),
            "delta_budget_arg": (None if service._delta_budget_arg is None
                                 else int(service._delta_budget_arg)),
            "max_clients": service.max_clients,
            "max_state_bytes": service.max_state_bytes,
        },
        "tree": tree_fingerprint(service.tree),
        "mesh": shd.mesh_signature(service.mesh),
    }
    if scheduler_state is not None:
        extras["scheduler"] = scheduler_state
    tree = {"state": service.gather_slots(service.state), "host": _host_mirrors(service)}
    # the other ranks go on once the files are there, and raise if the save failed
    path = _on_writer(service.mesh, lambda: ckpt.save(directory, int(step), tree, extras))
    return os.path.join(directory, f"step_{int(step):08d}") if path is None else path


def _zero_stats(capacity: int, sync_bytes: np.ndarray, device) -> ServiceStats:
    """A `ServiceStats` carrying only the restored per-slot wire bytes: the
    one column the rate controller's feedback reads."""
    zi = torch.zeros((capacity,), dtype=torch.int32, device=device)
    zf = torch.zeros((capacity,), dtype=torch.float32, device=device)
    zb = torch.zeros((capacity,), dtype=torch.bool, device=device)
    return ServiceStats(
        cut_size=zi, delta_size=zi, unique_delta=zi,
        sync_bytes=torch.as_tensor(np.asarray(sync_bytes, np.float32), device=device),
        dedup_bytes_saved=zf, nodes_touched=zi, resweeps=zi,
        client_resident=zi, overflow=zb, delta_overflow=zb,
        delta_shipped=zi, delta_deferred=zi, pages=zi,
        mtp_ms=zf, deadline_miss=zb)


def _read_extras(directory: str, step: int) -> Dict[str, Any]:
    try:
        extras = ckpt.read_extras(directory, step)
    except (OSError, ValueError, KeyError) as e:
        raise RecoveryError(f"snapshot step {step} manifest unreadable: {e}") from e
    if extras.get("format") != SNAPSHOT_FORMAT:
        raise RecoveryError(f"snapshot step {step} has format {extras.get('format')!r}, "
                            f"expected {SNAPSHOT_FORMAT!r}")
    return extras


def restore_service(tree: LodTree, directory: str, step: Optional[int] = None,
                    device: DeviceLike = None, mesh=None) -> LodService:
    """Rebuild a `LodService` from a snapshot of either package, its tensors
    on `device` (the card when None), onto the serving `mesh` (None: the
    meshless service; every rank of a mesh calls it and keeps its block).

    `tree` must be the same shared city tree the snapshot was taken against
    (fingerprint-checked). `step=None` restores the newest complete
    snapshot. Raises `RecoveryError` for anything that cannot restore
    faithfully: missing or torn snapshots, truncated leaf files, corrupt
    manifests, a mismatched tree, or snapshot halves that disagree."""
    svc, _ = _restore_with_extras(tree, directory, step, device, mesh)
    return svc


def _restore_with_extras(tree: LodTree, directory: str, step: Optional[int],
                         device: DeviceLike, mesh=None) -> Tuple[LodService, Dict[str, Any]]:
    if step is None:
        step = ckpt.latest_step(directory)
        if step is None:
            raise RecoveryError(f"no complete snapshot in {directory}")
    extras = _read_extras(directory, int(step))
    saved_fp = extras.get("tree", {})
    fp = tree_fingerprint(tree)
    if saved_fp != fp:
        raise RecoveryError(f"snapshot step {step} was taken against a different tree: "
                            f"saved {saved_fp}, have {fp}")
    try:
        cfg = SessionConfig(**extras["cfg"])
        srv = extras["service"]
        if srv["sweep_impl"] not in _SWEEP_IMPLS:
            raise ValueError(f"unknown sweep_impl {srv['sweep_impl']!r}")
        capacity = int(extras["capacity"])
        svc = LodService(
            tree, cfg, 0, focal=srv["focal"], mode=srv["mode"], dedup=srv["dedup"],
            delta_budget=srv["delta_budget_arg"], capacity=capacity,
            max_clients=srv["max_clients"], max_state_bytes=srv["max_state_bytes"],
            page_size=srv["page_size"], device=device, mesh=mesh)
    except (KeyError, TypeError, ValueError) as e:
        raise RecoveryError(f"snapshot step {step} has an unusable config: {e}") from e
    # the whole state is read on every rank (its global shapes), then each
    # keeps its block
    like = {"state": shd.global_shapes(svc.state, svc.client_shards),
            "host": _host_like(capacity)}
    try:
        restored = ckpt.restore(directory, int(step), like, device=svc.device)
    except (OSError, ValueError, KeyError, EOFError, ckpt.CheckpointDtypeError) as e:
        raise RecoveryError(f"snapshot step {step} unrestorable: {e}") from e
    whole = restored["state"]
    host = restored["host"]
    # the device FleetState and the host mirror were saved from one
    # consistent service: restored, they must still agree
    dev_active, dev_ids, dev_next = flt.fleet_mirror(whole.fleet)
    if (not np.array_equal(dev_active, host["active"])
            or not np.array_equal(dev_ids, host["client_ids"].astype(np.int64))
            or dev_next != int(extras["next_id"])):
        raise RecoveryError(f"snapshot step {step}: device FleetState disagrees with the "
                            f"snapshotted host mirror (active/client_ids/next_id)")
    svc._active = host["active"].copy()
    svc._client_ids = host["client_ids"].copy()
    svc._slot_cams = host["slot_cams"].copy()
    svc._delta_ids = host["delta_ids"].copy()
    svc._bw_target = host["bw_target"].copy()
    svc._allowance = host["allowance"].copy()
    svc._tau_scale = host["tau_scale"].copy()
    svc._stats_fresh = host["stats_fresh"].copy()
    svc._next_id = int(extras["next_id"])
    svc.taus = host["taus"].copy() if extras["has_taus"] else None
    svc.last_delta = None  # a per-sync artifact; tenancy refuses stale reads
    svc._block(whole, _zero_stats(capacity, host["last_sync_bytes"], svc.device)
               if extras["has_last_stats"] else None, None)
    return svc, extras


# ---------------------------------------------------------------------------
# sync journal
# ---------------------------------------------------------------------------


def _record_crc(rec: Dict[str, Any]) -> int:
    body = {k: v for k, v in rec.items() if k != "crc"}
    canon = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return zlib.crc32(canon.encode("utf-8")) & 0xFFFFFFFF


class SyncJournal:
    """Append-only CRC-framed JSONL journal of service inputs.

    One record a line: `{"seq": i, "kind": ..., ..., "crc": c}`, `seq` dense
    from 0 and `crc` a CRC32 over the canonical encoding of the other
    fields. An append flushes and fsyncs before it returns, so a record the
    caller saw appended survives the process."""

    def __init__(self, path: str, seq: int = 0, writer: bool = True):
        self.path = path
        self.seq = int(seq)
        # the ranks of a mesh count records alike, rank 0 alone writes them
        self.writer = bool(writer)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def append(self, rec: Dict[str, Any]) -> int:
        rec = dict(rec, seq=self.seq)
        rec["crc"] = _record_crc(rec)
        if self.writer:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())
        self.seq += 1
        return self.seq - 1

    @staticmethod
    def read(path: str, repair: bool = True) -> List[Dict[str, Any]]:
        """Validate and load every record. A bad line at the strict tail
        (possibly followed by more garbage, never by a valid record) is
        truncated away when `repair`; a bad line followed by a valid record,
        or a seq hole, is corruption in mid-file: `RecoveryError`."""
        if not os.path.exists(path):
            return []
        with open(path, "rb") as f:
            raw = f.read()
        records: List[Dict[str, Any]] = []
        good_bytes = 0
        offset = 0
        bad_at: Optional[int] = None
        lines = raw.split(b"\n")
        for i, line in enumerate(lines):
            # the last chunk has no newline: empty at a clean end, a torn
            # partial append otherwise
            end = offset + len(line) + (1 if i < len(lines) - 1 else 0)
            if line.strip():
                rec = None
                try:
                    parsed = json.loads(line.decode("utf-8"))
                    if isinstance(parsed, dict) and parsed.get("crc") == _record_crc(parsed):
                        rec = parsed
                except (ValueError, UnicodeDecodeError):
                    rec = None
                if rec is None:
                    if bad_at is None:
                        bad_at = len(records)
                elif bad_at is not None:
                    raise RecoveryError(f"journal {path} corrupt at record {bad_at} with "
                                        f"valid records after it — a hole, not a torn tail")
                elif rec.get("seq") != len(records):
                    raise RecoveryError(f"journal {path} record {len(records)} carries "
                                        f"seq {rec.get('seq')} — records are missing")
                else:
                    records.append(rec)
                    good_bytes = end
            offset = end
        if bad_at is not None and repair and good_bytes < len(raw):
            with open(path, "r+b") as f:
                f.truncate(good_bytes)
        return records


def _jsonable_cam(cam) -> Optional[List[float]]:
    if cam is None:
        return None
    # float32 → float64 → float32 is exact: the journal keeps the cameras'
    # bits
    return [float(x) for x in np.asarray(cam, np.float32)]


def _jsonable_bandwidth(bw):
    return bw if bw is None or isinstance(bw, str) else float(bw)


def replay(service: LodService, records) -> int:
    """Re-execute journal `records` in order against `service`; returns the
    number applied. The journal holds inputs only: every output (assigned
    client ids) is recomputed and, where the journal recorded it, checked:
    a mismatch means the replay is not the trajectory the journal
    describes, a `RecoveryError`."""
    n = 0
    for rec in records:
        kind = rec.get("kind")
        if kind == "sync":
            cams = rec.get("cams")
            part = rec.get("participate")
            service.sync(
                None if cams is None else {int(c): np.asarray(v, np.float32)
                                           for c, v in cams.items()},
                participate=None if part is None else [int(c) for c in part])
        elif kind == "admit":
            cid = service.admit(cam=rec.get("cam"), tau=rec.get("tau"),
                                bandwidth=rec.get("bandwidth"))
            if cid != rec["id"]:
                raise RecoveryError(f"replay diverged: journal admit assigned id "
                                    f"{rec['id']}, replay assigned {cid}")
        elif kind == "evict":
            service.evict(rec["id"])
        elif kind == "nack":
            service.nack_rows(rec["id"], rec.get("gids", []))
        elif kind == "bandwidth":
            service.set_bandwidth(rec["id"], rec.get("target"))
        elif kind == "shrink":
            service.maybe_shrink()
        else:
            raise RecoveryError(f"unknown journal record kind {kind!r} "
                                f"(seq {rec.get('seq')})")
        n += 1
    return n


# ---------------------------------------------------------------------------
# snapshot-every-K orchestration
# ---------------------------------------------------------------------------


class RecoveryManager:
    """Crash-recoverable wrapper around a live `LodService`: every mutating
    call is journaled before it runs, and every `every` syncs the whole
    service is snapshotted (keep-last-`keep` bounds the disk; the journal
    bounds replay to at most `every` syncs). Drive the service through this
    wrapper: a mutation that bypasses it is invisible to recovery.

    Layout under `directory`:
        snapshots/step_<seq>/   — snapshot taken after journal record seq-1
        journal.jsonl           — the whole input history (seq 0 onward)

    `recover(tree, directory)` rebuilds the newest restorable snapshot and
    replays the journal's tail: the service comes back bit for bit at the
    last sync the journal recorded."""

    def __init__(self, service: LodService, directory: str, every: int = 8,
                 keep: int = 3, *, scheduler=None, _resume_seq: Optional[int] = None):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.service = service
        # an optional DeadlineScheduler whose state_dict() rides in every
        # snapshot's extras (`recover(...)[0].scheduler_state`)
        self.scheduler = scheduler
        self.directory = directory
        self.snapshot_dir = os.path.join(directory, SNAPSHOT_DIRNAME)
        self.every = int(every)
        self.keep = int(keep)
        os.makedirs(self.snapshot_dir, exist_ok=True)
        self.journal = SyncJournal(os.path.join(directory, JOURNAL_NAME),
                                   seq=0 if _resume_seq is None else _resume_seq,
                                   writer=_writes(service.mesh))
        self._since_snapshot = 0
        self.scheduler_state: Optional[Dict[str, Any]] = None
        self.saved_mesh = None
        if _resume_seq is None:
            # a base snapshot: recovery has a restore point even if the
            # process dies before the first interval ends
            self._snapshot()

    # -- persistence ------------------------------------------------------------

    def _snapshot(self) -> None:
        snapshot_service(self.service, self.snapshot_dir, step=self.journal.seq,
                         journal_seq=self.journal.seq,
                         scheduler_state=None if self.scheduler is None
                         else self.scheduler.state_dict())
        self._since_snapshot = 0
        self._gc()

    def _gc(self) -> None:
        if not _writes(self.service.mesh):
            return
        for s in ckpt.valid_steps(self.snapshot_dir)[self.keep:]:
            shutil.rmtree(os.path.join(self.snapshot_dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def snapshot_now(self) -> None:
        """Snapshot at the current journal position (before a planned
        shutdown, say, so that recovery replays nothing)."""
        self._snapshot()

    # -- the journaled service API ------------------------------------------------

    def sync(self, cam_positions=None, participate=None) -> ServiceStats:
        if isinstance(cam_positions, dict):
            cams = {str(int(c)): _jsonable_cam(v) for c, v in cam_positions.items()}
        elif cam_positions is not None:
            arr = np.asarray(cam_positions, np.float32)
            cams = {str(int(c)): _jsonable_cam(row)
                    for c, row in zip(self.service.active_ids, arr)}
        else:
            cams = None
        if participate is not None:
            # journal stable client ids, not slots: a replay may land on a
            # service whose slots moved (a shrink), but ids name the clients
            mask = self.service._participation_mask(participate)
            part = sorted(int(c) for c in np.asarray(
                self.service._client_ids)[mask & self.service._active])
        else:
            part = None
        self.journal.append({"kind": "sync", "cams": cams, "participate": part})
        stats = self.service.sync(
            None if cams is None else {int(c): np.asarray(v, np.float32)
                                       for c, v in cams.items()},
            participate=part)
        self._since_snapshot += 1
        if self._since_snapshot >= self.every:
            self._snapshot()
        return stats

    def admit(self, cam=None, tau=None, required: bool = True,
              bandwidth=None) -> Optional[int]:
        # admission is checked first, so a denied admit never enters the
        # journal (a replay would raise mid-recovery)
        denial = self.service._admission_denial()
        if denial is not None:
            if required:
                raise AdmissionDenied(denial)
            return None
        cid = int(self.service._next_id)
        self.journal.append({
            "kind": "admit", "id": cid, "cam": _jsonable_cam(cam),
            "tau": None if tau is None else float(tau),
            "bandwidth": _jsonable_bandwidth(bandwidth)})
        got = self.service.admit(cam=cam, tau=tau, bandwidth=bandwidth)
        if got != cid:
            raise RecoveryError(f"admit assigned id {got}, journal predicted {cid}")
        return got

    def evict(self, client_id: int) -> None:
        self.service._slot_of(client_id)  # validated before it is journaled
        self.journal.append({"kind": "evict", "id": int(client_id)})
        self.service.evict(client_id)

    def nack(self, client_id: int, lost_pages) -> int:
        # the resolved gids, not page numbers: a replay must not depend on
        # a payload that died with the crashed process
        gids = self.service.resolve_nack(client_id, lost_pages)
        self.journal.append({"kind": "nack", "id": int(client_id),
                             "gids": [int(g) for g in gids]})
        return self.service.nack_rows(client_id, gids)

    def set_bandwidth(self, client_id: int, bandwidth=None) -> None:
        self.service._slot_of(client_id)  # validated before it is journaled
        self.journal.append({"kind": "bandwidth", "id": int(client_id),
                             "target": _jsonable_bandwidth(bandwidth)})
        self.service.set_bandwidth(client_id, bandwidth)

    def maybe_shrink(self) -> Optional[int]:
        self.journal.append({"kind": "shrink"})
        return self.service.maybe_shrink()


def recover(tree: LodTree, directory: str, every: int = 8, keep: int = 3,
            device: DeviceLike = None, mesh=None) -> Tuple[RecoveryManager, int]:
    """Crash recovery: restore the newest intact snapshot under `directory`
    onto `device` (the card when None) and the serving `mesh` (None:
    meshless; every rank of a mesh calls it, rank 0 repairs the directory
    first), and re-execute the journal's tail.

    Walks complete snapshots newest first: one that turns out torn,
    truncated or corrupt falls back to the one before it (a longer tail,
    nothing lost but replay time). Leftover `step_*.tmp` directories of
    killed saves are swept away; a torn journal tail is truncated; a
    journal hole raises. Returns `(manager, replayed)`: a `RecoveryManager`
    resumed at the journal's head (its `scheduler_state` is the snapshot's
    scheduler state or None, its `saved_mesh` the mesh signature the
    snapshot was taken under) and the number of records re-executed.
    Raises `RecoveryError` when no snapshot can be restored."""
    snap_dir = os.path.join(directory, SNAPSHOT_DIRNAME)
    journal = os.path.join(directory, JOURNAL_NAME)
    def repair():
        if os.path.isdir(snap_dir):
            for name in os.listdir(snap_dir):
                if name.endswith(".tmp"):
                    shutil.rmtree(os.path.join(snap_dir, name), ignore_errors=True)
        return SyncJournal.read(journal, repair=True)

    # the other ranks read the directory once rank 0 has repaired it, and
    # raise if the repair failed
    records = _on_writer(mesh, repair)
    if not _writes(mesh):
        records = SyncJournal.read(journal, repair=False)
    failures: List[str] = []
    for step in ckpt.valid_steps(snap_dir):
        try:
            svc, extras = _restore_with_extras(tree, snap_dir, step, device, mesh)
        except RecoveryError as e:
            failures.append(str(e))
            continue
        base = int(extras.get("journal_seq", 0))
        if base > len(records):
            failures.append(f"snapshot step {step} is ahead of the journal "
                            f"({base} > {len(records)} records)")
            continue
        replayed = replay(svc, records[base:])
        manager = RecoveryManager(svc, directory, every=every, keep=keep,
                                  _resume_seq=len(records))
        # the caller rebuilds a DeadlineScheduler around the service and
        # load_state_dict()s this: the journal replays partial syncs, but
        # the fitted cost model and the deadlines live in the scheduler
        manager.scheduler_state = extras.get("scheduler")
        manager.saved_mesh = extras.get("mesh")
        return manager, replayed
    detail = "; ".join(failures) if failures else "no complete snapshot"
    raise RecoveryError(f"cannot recover from {directory}: {detail}")
