"""A fleet of headsets synced by one cloud service, worked out by the
reference at chosen syncs, and the comparison of what a run reported there.

Every client is synced at every sync, each at its own camera and τ. A
client's table at sync k depends only on its cuts at syncs k − w_star − 1
.. k (a row is held while it was in a cut within the last w_star syncs),
so `Model.sync(k, cams)` replays those syncs from an empty table. The
fleet's payload is the union of the clients' Δ rows, encoded once, every
row shipped (the configuration's Δ budget holds the largest union);
client b ingests its own Δ rows."""

from __future__ import annotations

import torch

from nebula_bench.reference import codec as RC
from nebula_bench.reference import lod as RL
from nebula_bench.reference import tables as RT
from nebula_bench.reference.session import ac_excess, diagnose, rows_off


class Model:
    def __init__(self, scene, cfg: dict, device, dtype=torch.float32):
        self.cfg, self.dtype, self.device = cfg, dtype, device
        s = cfg["session"]
        self.w_star = s["w_star"]
        self.focal = float(torch.tensor(cfg["rig"]["focal"], dtype=torch.float32))
        self.taus = [float(t) for t in cfg["fleet"]["taus"]]
        self.tree = RL.Tree(scene, device, dtype)
        self.codec = RC.Codec(scene.padded, device, dtype, k_codes=s["k_codes"])
        self.bpg = RT.bytes_per_gaussian(s["k_codes"])
        self.page_size = cfg["budgets"]["page_size"]
        self.n_pad = scene.n_pad
        self.raw = {k: torch.as_tensor(scene.padded[k], device=device)
                    for k in ("mu", "log_scale", "quat", "opacity", "sh")}

    def tau(self, b: int) -> float:
        return self.taus[b % len(self.taus)]

    def sync(self, k: int, cams) -> dict:
        """Sync k of the fleet; `cams[j]` is the (clients, 3) cameras of sync j."""
        n = cams[k].shape[0]
        cuts, deltas, moved = [], [], []
        for b in range(n):
            client = RT.Client(self.n_pad, self.device)
            for j in range(max(0, k - self.w_star - 1), k + 1):
                cut = self.tree.cut(cams[j][b], self.focal, self.tau(b))
                delta, mv = client.sync(cut, j, self.w_star)
            cuts.append(cut)
            deltas.append(delta)
            moved.append(mv)
        deltas = torch.stack(deltas)
        return dict(cuts=cuts, deltas=deltas,
                    bytes=RT.fleet_bytes(deltas, moved, self.bpg, self.tree.level_of_row,
                                         self.page_size))

    def rows(self, ids: torch.Tensor) -> dict:
        return self.codec.roundtrip({k: v[ids] for k, v in self.raw.items()})


def compare(got, model: Model, cams, syncs, diag=None) -> tuple:
    """({check: value}, syncs found wrong) over the chosen syncs. `got`
    gives, at a chosen sync, `stats(k)` (per-client lists: cut_size,
    delta_size, sync_bytes), `cut_ids(k, b)`, `union(k)` (the union's row
    ids, shipped rows only), `client_rows(k, b)` (the row ids b ingests)
    and `decoded(k)` (the decoded union rows, in `union(k)`'s order)."""
    diag = {} if diag is None else diag
    cut_off = counts_off = delta_off = 0
    bytes_gap = 0.0
    rows_bad = rows_n = 0
    wrong = set()
    for k in sorted(syncs):
        want = model.sync(k, cams)
        st = got.stats(k)
        before = (cut_off, counts_off, delta_off, rows_bad)
        gap = 0.0
        for b, cut in enumerate(want["cuts"]):
            mask = torch.zeros_like(cut)
            ids = got.cut_ids(k, b).to(model.device).long()
            mask[ids[ids >= 0]] = True
            cut_off += int((mask ^ cut).sum())
            d = want["deltas"][b]
            counts_off += abs(st["cut_size"][b] - int(cut.sum()))
            counts_off += abs(st["delta_size"][b] - int(d.sum()))
            mine = torch.zeros_like(d)
            rows = got.client_rows(k, b).to(model.device).long()
            mine[rows] = True
            delta_off += int((mine ^ d).sum()) + (rows.numel() - int(mine.sum()))
            gap = max(gap, abs(st["sync_bytes"][b] - want["bytes"][b]) / want["bytes"][b])
        union = got.union(k).to(model.device).long()
        want_union = want["deltas"].any(0)
        in_union = torch.zeros_like(want_union)
        in_union[union] = True
        delta_off += int((in_union ^ want_union).sum())
        g_rows, w_rows, raw = got.decoded(k), model.rows(union), model.raw["sh"][union]
        for key in w_rows:
            diagnose(diag, "payload." + key, g_rows[key], w_rows[key])
        diagnose(diag, "payload.ac_excess", ac_excess(g_rows["sh"], w_rows["sh"], raw)
                 .clamp_min(0)[:, None], torch.zeros(union.numel(), 1, device=union.device))
        bad = rows_off(g_rows, w_rows, raw)
        rows_bad, rows_n = rows_bad + int(bad.sum()), rows_n + union.numel()
        bytes_gap = max(bytes_gap, gap)
        if (cut_off, counts_off, delta_off, rows_bad) != before or gap > 1e-6:
            wrong.add(k)
    checks = dict(cut_ids_off=cut_off, counts_off=counts_off, delta_rows_off=delta_off,
                  bytes_gap=bytes_gap, payload_rows_off=rows_bad / max(rows_n, 1))
    return checks, wrong


class Replay:
    """A model put in the program's place (the control)."""

    def __init__(self, model: Model, cams, syncs):
        self.m, self.out = model, {}
        for k in syncs:
            s = model.sync(k, cams)
            union = torch.nonzero(s["deltas"].any(0), as_tuple=True)[0]
            self.out[k] = dict(s, union=union, decoded=model.rows(union))

    def stats(self, k):
        o = self.out[k]
        return dict(cut_size=[int(c.sum()) for c in o["cuts"]],
                    delta_size=[int(d.sum()) for d in o["deltas"]], sync_bytes=o["bytes"])

    def cut_ids(self, k, b):
        return torch.nonzero(self.out[k]["cuts"][b], as_tuple=True)[0]

    def union(self, k):
        return self.out[k]["union"]

    def client_rows(self, k, b):
        return torch.nonzero(self.out[k]["deltas"][b], as_tuple=True)[0]

    def decoded(self, k):
        return self.out[k]["decoded"]
