"""The comparison that decides `correct` fails where it must: the control
(the reference computed in bfloat16 and put in the program's place), and
whole runs with the timed path broken underneath (a step that returns its
state unchanged, half of the batch left out, an answer altered where it is
produced). A fleet on one chip has no exchange between chips to leave out."""

import dataclasses
import json
import time

import pytest
import torch

from nebula_bench import harness as H
from nebula_bench import run as R
from nebula_bench import scene as SC
from nebula_bench import traffic as TR
from nebula_bench.reference import fleet as RFL
from nebula_bench.reference import session as RSE
from repro_torch.core import manager as MG
from repro_torch.core import pipeline as P
from repro_torch.serve import lod_service as SV

CPU = torch.device("cpu")


def load(root, name):
    return (H.load_json(root / f"nebula_bench/configs/{name}.json"),
            H.load_json(root / "nebula_bench/traffic/vehicle.json"))


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_the_control_fails_the_session_check(tiny_root, seed):
    cfg, traffic = load(tiny_root, "city24-quest3")
    scene = SC.build_scene(cfg, seed)
    pos, rot = (torch.as_tensor(x) for x in TR.Headset(traffic, cfg["city"], seed, 0).poses(0, 24))
    samples, last = {9, 23}, 23
    control = RSE.Replay(RSE.Model(scene, cfg, CPU, torch.bfloat16), pos, rot, last, samples)
    checks, wrong, _ = RSE.compare(control, RSE.Model(scene, cfg, CPU), pos, rot, last, samples)
    assert not H.passed(H.judge(checks, cfg["limits"])), checks
    sound = RSE.Replay(RSE.Model(scene, cfg, CPU), pos, rot, last, samples)
    checks, _, _ = RSE.compare(sound, RSE.Model(scene, cfg, CPU), pos, rot, last, samples)
    assert H.passed(H.judge(checks, cfg["limits"])), checks


def test_the_control_fails_the_fleet_check(tiny_root):
    cfg, traffic = load(tiny_root, "city24-fleet16")
    seed, w = 4, cfg["session"]["w"]
    scene = SC.build_scene(cfg, seed)
    cams = torch.stack([torch.as_tensor(TR.Headset(traffic, cfg["city"], seed, c)
                                        .poses(0, 64)[0][::w]) for c in range(3)], 1)
    syncs = {0, 7, 12}
    control = RFL.Replay(RFL.Model(scene, cfg, CPU, torch.bfloat16), cams, syncs)
    checks, _ = RFL.compare(control, RFL.Model(scene, cfg, CPU), cams, syncs)
    assert not H.passed(H.judge(checks, cfg["limits"])), checks


def run_broken(root, workload, patch, monkeypatch):
    for target, name, fn in patch:
        monkeypatch.setattr(target, name, fn)
    line, judged = R.run_cell(root, workload, 11, 1.5, False, CPU, time.perf_counter())
    return json.loads(line)



def _half_queue(store, gids):
    q = _half_queue.real(store, gids)
    keep = torch.arange(gids.shape[0]) % 2 == 0
    return dataclasses.replace(q, opacity=torch.where(keep, q.opacity, 0.0))


def _altered_bytes(*a, **kw):
    state, stats = _altered_bytes.real(*a, **kw)
    return state, dataclasses.replace(stats, sync_bytes=stats.sync_bytes + 1.0)


@pytest.mark.parametrize("fault", ["state unchanged", "half the queue", "altered bytes"])
def test_a_broken_session_is_not_correct(tiny_root, monkeypatch, fault):
    real_sync = P.cloud_sync_step
    _half_queue.real, _altered_bytes.real = P._render_queue, real_sync
    if fault == "state unchanged":
        def unchanged(tree, codec, cfg, state, *a, **kw):
            if state.frame_index == 0:          # the cold sync fills the store
                return real_sync(tree, codec, cfg, state, *a, **kw)
            _new, stats = real_sync(tree, codec, cfg, state, *a, **kw)
            return dataclasses.replace(state, frame_index=state.frame_index + 1,
                                       sync_index=state.sync_index + 1), stats
        patch = [(P, "cloud_sync_step", unchanged)]
    elif fault == "half the queue":
        patch = [(P, "_render_queue", _half_queue)]
    else:
        patch = [(P, "cloud_sync_step", _altered_bytes)]
    out = run_broken(tiny_root, "city24-quest3.vehicle", patch, monkeypatch)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["state unchanged", "half the fleet", "altered bytes"])
def test_a_broken_fleet_is_not_correct(tiny_root, monkeypatch, fault):
    real_finish, real_eff, real_bytes = SV._finish_sync, SV._effective_slots, \
        MG.batched_wire_bytes
    if fault == "state unchanged":
        def unchanged(tree, cfg, state, *a, **kw):
            new, stats, batch = real_finish(tree, cfg, state, *a, **kw)
            return (dataclasses.replace(new, cut_gids=state.cut_gids, mgr=state.mgr)
                    if int(state.sync_index[0]) > 0 else new), stats, batch
        patch = [(SV, "_finish_sync", unchanged)]
    elif fault == "half the fleet":
        def half(state, participate):
            eff = real_eff(state, participate)
            return eff & (torch.arange(eff.shape[0], device=eff.device) < eff.shape[0] // 2)
        patch = [(SV, "_effective_slots", half)]
    else:
        def altered(*a, **kw):
            out = real_bytes(*a, **kw)
            return out + (torch.arange(out.shape[0], device=out.device) == 0).float()
        patch = [(MG, "batched_wire_bytes", altered)]
    out = run_broken(tiny_root, "fleet.vehicle", patch, monkeypatch)
    assert not out["correct"], out["checks"]
