"""One headset's collaborative session, worked out by the reference, and
the comparison that decides whether a run's outputs are correct.

`Model` follows the session frame by frame: a sync every `w` frames (the
cut at that frame's camera, the client's table, the Δ and the bytes), the
pose's 100 bytes on the other frames; `rows` gives rows as the client
decodes them, `images` both eyes of a frame. `compare` walks the frames a
run made and holds what the run reports (`got`: `stats(f)`,
`cut_ids(f)` on sync frames, `store_rows(f, rows)` and `images(f)` on
sampled frames) to the model's."""

from __future__ import annotations

import torch

from nebula_bench.reference import codec as RC
from nebula_bench.reference import lod as RL
from nebula_bench.reference import render as RR
from nebula_bench.reference import tables as RT

PIXEL_TOL = 1.0 / 255.0     # a pixel is off where a channel differs by more
ROW_RTOL = 1e-5             # a decoded value is off beyond this, relative to 1 + |value|,
# except: a quaternion component may lie one 16-bit step off (its rounding
# ties differently on a norm a few ulp apart), and a row's SH AC is held to
# how near the row's own AC it decodes: no farther than the reference's
# codeword by more than AC_TOL (the codebook is fit with float sums in an
# order the device does not fix, so two fits differ run to run)
QUAT_TOL = 1.0 / 32767.0 + 1e-6
AC_TOL = 5e-3


class Model:
    def __init__(self, scene, cfg: dict, device, dtype=torch.float32):
        self.cfg, self.dtype, self.device = cfg, dtype, device
        s = cfg["session"]
        self.w, self.w_star, self.tau = s["w"], s["w_star"], float(s["tau"])
        self.focal = float(torch.tensor(cfg["rig"]["focal"], dtype=torch.float32))
        self.tree = RL.Tree(scene, device, dtype)
        self.codec = RC.Codec(scene.padded, device, dtype, k_codes=s["k_codes"])
        self.bpg = RT.bytes_per_gaussian(s["k_codes"])
        self.client = RT.Client(scene.n_pad, device)
        self.raw = {k: torch.as_tensor(scene.padded[k], device=device)
                    for k in ("mu", "log_scale", "quat", "opacity", "sh")}
        self.cut = None
        self.sent = {}          # frame -> bytes sent to the headset

    def frame(self, f: int, pos) -> dict:
        if f % self.w:
            out = dict(synced=False, cut_size=int(self.cut.sum()), delta_size=0,
                       sync_bytes=float(RT.POSE_BYTES))
        else:
            self.cut = self.tree.cut(pos, self.focal, self.tau)
            delta, moved = self.client.sync(self.cut, f // self.w, self.w_star)
            n_delta = int(delta.sum())
            out = dict(synced=True, cut_size=int(self.cut.sum()), delta_size=n_delta,
                       sync_bytes=RT.unicast_bytes(n_delta, moved, self.bpg))
        self.sent[f] = out["sync_bytes"]
        return out

    def rows(self, ids: torch.Tensor) -> dict:
        return self.codec.roundtrip({k: v[ids] for k, v in self.raw.items()})

    def images(self, pos, rot):
        """(left, right, pairs) of the current cut seen from the pose."""
        rig = self.cfg["rig"]
        s = self.cfg["session"]
        queue = self.rows(torch.nonzero(self.cut, as_tuple=True)[0])
        left, pairs_l = RR.render_eye(queue, pos, rot, rig, s["tile"], s["list_len"],
                                      self.dtype)
        right, pairs_r = RR.render_eye(queue, pos, rot, rig, s["tile"], s["list_len"],
                                       self.dtype, rig["baseline"])
        return left, right, max(pairs_l, pairs_r)


def ac_excess(got_sh, want_sh, raw_sh) -> torch.Tensor:
    """(n,) how much farther a row's decoded SH AC lies from its own AC than
    the reference's does."""
    def err(sh):
        return (sh[:, 1:].float() - raw_sh[:, 1:].float()).flatten(1).norm(dim=1)
    return err(got_sh) - err(want_sh)


def rows_off(got: dict, want: dict, raw_sh) -> torch.Tensor:
    """(n,) bool: rows whose decoded values differ beyond their tolerance."""
    off = None
    for k, w in want.items():
        g, w = (x.float().reshape(x.shape[0], -1) if x.shape[0] else
                x.float().reshape(0, max(1, x[0:1].numel())) for x in (got[k], w))
        tol = ROW_RTOL * (1.0 + w.abs())
        if k == "quat":
            tol = torch.full_like(w, QUAT_TOL)
        elif k == "sh":
            g, w, tol = g[:, :3], w[:, :3], tol[:, :3]      # the DC; the AC below
        bad = ((g - w).abs() > tol).any(1) | ~torch.isfinite(g).all(1)
        off = bad if off is None else off | bad
    if "sh" in want and want["sh"].shape[1] > 1:
        excess = ac_excess(got["sh"], want["sh"], raw_sh)
        off = off | (excess > AC_TOL) | ~torch.isfinite(excess)
    return off


def diagnose(diag: dict, key: str, got, want) -> None:
    """Accumulate, for the run's record, how far values lie from the
    reference's: the largest gap and how many rows or pixels lie beyond
    each of a few gaps."""
    e = diag.setdefault(key, dict(n=0, max=0.0, **{f">{t:g}": 0 for t in (1e-5, 1e-3, 1e-2,
                                                                           1e-1)}))
    if not want.shape[0]:
        return
    g, w = (x.float().reshape(x.shape[0], -1) for x in (got, want))
    gap = (g - w).abs().amax(1)
    e["n"] += gap.numel()
    e["max"] = max(e["max"], float(gap.max()))
    for t in (1e-5, 1e-3, 1e-2, 1e-1):
        e[f">{t:g}"] += int((gap > t).sum())


def pixels_off(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(pixels off, pixels) of one image."""
    diff = (got.float() - want).abs().amax(-1)
    bad = (diff > PIXEL_TOL) | ~torch.isfinite(diff)
    return int(bad.sum()), bad.numel()


def compare(got, model: Model, pos, rot, last: int, samples, diag=None) -> tuple:
    """({check: value}, frames found wrong, the most pairs an eye needed)
    over frames 0 .. last; `diag` gathers how far values lie."""
    diag = {} if diag is None else diag
    cut_off = counts_off = 0
    bytes_gap = 0.0
    wrong = set()
    store_bad = store_n = px_bad = px_n = 0
    pairs = 0
    for f in range(last + 1):
        want = model.frame(f, pos[f])
        st = got.stats(f)
        c = abs(st["cut_size"] - want["cut_size"]) + abs(st["delta_size"] - want["delta_size"])
        c += int(st["synced"] != want["synced"])
        gap = abs(st["sync_bytes"] - want["sync_bytes"]) / want["sync_bytes"]
        k = 0
        if want["synced"]:
            mask = torch.zeros_like(model.cut)
            ids = got.cut_ids(f).to(model.device).long()
            mask[ids[ids >= 0]] = True
            k = int((mask ^ model.cut).sum())
        cut_off, counts_off, bytes_gap = cut_off + k, counts_off + c, max(bytes_gap, gap)
        if k or c or gap > 1e-6:
            wrong.add(f)
        if f in samples:
            held = torch.nonzero(model.client.has, as_tuple=True)[0]
            g_rows, w_rows, raw = got.store_rows(f, held), model.rows(held), model.raw["sh"][held]
            for key in w_rows:
                diagnose(diag, "store." + key, g_rows[key], w_rows[key])
            diagnose(diag, "store.ac_excess", ac_excess(g_rows["sh"], w_rows["sh"], raw)
                     .clamp_min(0)[:, None], torch.zeros(held.numel(), 1, device=held.device))
            bad = int(rows_off(g_rows, w_rows, raw).sum())
            store_bad, store_n = store_bad + bad, store_n + held.numel()
            left, right, n_pairs = model.images(pos[f], rot[f])
            pairs = max(pairs, n_pairs)
            g_left, g_right = got.images(f)
            for eye, g, w in (("left", g_left, left), ("right", g_right, right)):
                diagnose(diag, "pixels." + eye, g.reshape(-1, 3), w.reshape(-1, 3))
                b, n = pixels_off(g, w)
                px_bad, px_n = px_bad + b, px_n + n
            if bad or px_bad:
                wrong.add(f)
    checks = dict(cut_ids_off=cut_off, counts_off=counts_off, bytes_gap=bytes_gap,
                  store_rows_off=store_bad / max(store_n, 1), pixels_off=px_bad / max(px_n, 1))
    return checks, wrong, pairs


class Replay:
    """A model put in the program's place (the control): what it reports,
    in `compare`'s terms."""

    def __init__(self, model: Model, pos, rot, last: int, samples):
        self.st, self.ids, self.store, self.img = {}, {}, {}, {}
        for f in range(last + 1):
            self.st[f] = model.frame(f, pos[f])
            if self.st[f]["synced"]:
                self.ids[f] = torch.nonzero(model.cut, as_tuple=True)[0]
            if f in samples:
                self.store[f] = model
                self.img[f] = model.images(pos[f], rot[f])[:2]

    def stats(self, f):
        return self.st[f]

    def cut_ids(self, f):
        return self.ids[f]

    def store_rows(self, f, rows):
        return self.store[f].rows(rows)

    def images(self, f):
        return self.img[f]
