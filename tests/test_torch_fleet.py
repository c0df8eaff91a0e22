"""Port parity for the fleet slice: the batched LoD search pieces, K6's plain
version, the batched management tables and wire bytes, the encode-once Δ
stream, the `LodService` (pooled and vmapped) and the fleet fallback render
of `repro_torch` against the JAX package on the same inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, assert_close, assert_equal, np_, to_torch_codec,
                           to_torch_rig, to_torch_tree)

from repro.core import lod_search as jls
from repro.core import manager as jmgr
from repro.core import pipeline as jpipe
from repro.core.camera import StereoRig, make_camera
from repro.core.pipeline import SessionConfig as JConfig
from repro.kernels.lod_cut import lod_pair_sweep_pallas
from repro.serve import delta_path as jdp
from repro.serve import lod_service as jsvc
from repro_torch import kernels as tkernels
from repro_torch import pytree
from repro_torch.core import compression as tcomp
from repro_torch.core import lod_search as tls
from repro_torch.core import manager as tmgr
from repro_torch.core.pipeline import SessionConfig as TConfig
from repro_torch.serve import delta_path as tdp
from repro_torch.serve import lod_service as tsvc

FOCAL = 1400.0
B, SYNCS = 3, 4
TAUS = np.array([32.0, 56.0, 32.0], np.float32)  # foveated: client 1 is coarser
CFG = dict(tau=32.0, w=4, w_star=32, cut_budget=8192)
STAT_FIELDS = [f.name for f in dataclasses.fields(tsvc.ServiceStats)]


def _walks(seed=0):
    """(SYNCS, B, 3) correlated random walks, one headset per column."""
    rng = np.random.default_rng(seed)
    cams = [np.asarray([30.0, 30.0, 2.0], np.float32) + rng.normal(0, 25.0, (B, 3))]
    cams[0][:, 2] = np.abs(cams[0][:, 2]) + 1.0
    for _ in range(SYNCS - 1):
        cams.append(cams[-1] + rng.normal(0, 4.0, (B, 3)))
    return np.stack(cams).astype(np.float32)


@pytest.fixture(scope="module")
def trees(small_tree, tiny_tree):
    return {"small": (small_tree, to_torch_tree(small_tree)),
            "tiny": (tiny_tree, to_torch_tree(tiny_tree))}


def _tstate(jstate):
    """A JAX TemporalState (batched or not) carried into the port."""
    return tls.TemporalState(**{f.name: torch.from_numpy(np.array(getattr(jstate, f.name)))
                                for f in dataclasses.fields(tls.TemporalState)})


# -- search pieces -----------------------------------------------------------


def test_top_staleness_pairs_and_hybrid_exact(trees):
    """batched_top_and_staleness (per-client τ, one slot inactive),
    sweep_slab_camera_pairs over the stale pairs (per-pair τ) and the
    hybrid search, each against JAX over a short walk."""
    jt, tt = trees["small"]
    m = jt.meta
    walks = _walks(1)
    jstates = jls.TemporalState.initial_batched(m.Ns, m.S, B)
    active = np.array([True, True, False])
    for f in range(SYNCS):
        jtop, jrpe, jstale = jls.batched_top_and_staleness(
            jt, jstates, walks[f], jnp.float32(FOCAL), jnp.asarray(TAUS),
            jnp.asarray(active))
        ttop, trpe, tstale = tls.batched_top_and_staleness(
            tt, _tstate(jstates), walks[f], FOCAL, torch.from_numpy(TAUS),
            torch.from_numpy(active))
        for a, b in ((ttop, jtop), (trpe, jrpe), (tstale, jstale)):
            assert_equal(a, b)
        assert not bool(tstale[2].any())
        sb, ss = np.nonzero(np.asarray(jstale))
        if sb.size:
            g = (jt.slab_mu()[ss], jt.slab_size()[ss], jt.slab_parent[ss],
                 jt.slab_level[ss], jt.slab_is_leaf[ss], jt.slab_valid[ss],
                 jrpe[sb, ss], jnp.asarray(walks[f][sb]))
            want = jls.sweep_slab_camera_pairs(*g, jnp.float32(FOCAL),
                                               jnp.asarray(TAUS[sb]), m.slab_max_depth)
            got = tls.sweep_slab_camera_pairs(*(torch.from_numpy(np.array(x)) for x in g),
                                              FOCAL, torch.from_numpy(TAUS[sb]),
                                              m.slab_max_depth)
            for a, b in zip(got, want):
                assert_equal(a, b)
        _cut, jstates = jls.batched_temporal_search(jt, jstates, walks[f],
                                                    jnp.float32(FOCAL), jnp.asarray(TAUS))
    jstate = jls.TemporalState.initial(m.Ns, m.S)
    tstate = _tstate(jstate)
    for f in range(SYNCS):
        jc, jstate = jls.temporal_search_hybrid(jt, jstate, walks[f, 0], FOCAL, 40.0)
        tc, tstate = tls.temporal_search_hybrid(tt, tstate, walks[f, 0], FOCAL, 40.0)
        assert_equal(tc.mask(tt), jc.mask(jt))
        assert_equal(tc.resweep, jc.resweep)
        assert int(tc.nodes_touched) == int(jc.nodes_touched)
        for fld in ("cam0", "rho", "parent_expand0", "slab_cut0", "root_expand0"):
            assert_equal(getattr(tstate, fld), getattr(jstate, fld), fld)


def test_pair_sweep_plain_matches_pallas(trees):
    """K6's plain version against the reference's Pallas pair kernel
    (interpret mode) on the gathered pairs of `tiny_tree`, with a camera and
    τ per pair."""
    jt, tt = trees["tiny"]
    m = jt.meta
    rng = np.random.default_rng(3)
    k = 2 * m.Ns
    ss = rng.integers(0, m.Ns, k)
    cams = (rng.normal(0, 20.0, (k, 3)) + [0, 0, 10]).astype(np.float32)
    taus = rng.choice(np.array([8.0, 16.0, 48.0], np.float32), k)
    rpe = rng.random(k) < 0.8
    g = [np.array(x[ss]) for x in (jt.slab_mu(), jt.slab_size(), jt.slab_parent,
                                   jt.slab_level, jt.slab_is_leaf, jt.slab_valid)]
    want = lod_pair_sweep_pallas(*g, rpe, cams, jnp.float32(FOCAL), taus,
                                 max_depth=m.slab_max_depth, interpret=True)
    tkernels.reset_launch_counts()
    got = tkernels.wrappers()["lod_pair_sweep"](
        *(torch.from_numpy(x) for x in g), torch.from_numpy(rpe), torch.from_numpy(cams),
        FOCAL, torch.from_numpy(taus), max_depth=m.slab_max_depth)
    assert tkernels.launch_counts()["lod_pair_sweep"] == 0  # CPU: plain version
    assert_equal(got[0], want[0])
    assert_equal(got[1], want[1])
    assert bool(got[0].any())


# -- tables, wire bytes, Δ stream ---------------------------------------------


def _batched(state):
    """A JAX pytree broadcast to B slots."""
    return jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a[None], (B,) + a.shape),
                                  state)


def _t(kw):
    """Keyword arrays carried into the port."""
    return {k: v if isinstance(v, bool) else torch.from_numpy(np.array(v))
            for k, v in kw.items()}


def test_batched_tables_wire_bytes_and_delta_batch_exact(trees):
    """batched_cloud_sync and batched_wire_bytes (unicast and shared, with
    an inactive slot), then build_delta_batch with a budget smaller than the
    union, so pages defer."""
    jt, tt = trees["small"]
    m = jt.meta
    walks = _walks(2)
    jcut, _ = jls.batched_temporal_search(jt, jls.TemporalState.initial_batched(
        m.Ns, m.S, B), walks[0], jnp.float32(FOCAL), jnp.asarray(TAUS))
    masks = jls.batched_cut_mask(jcut, jt)
    jstates = _batched(jmgr.ManagerState.initial(jt.n_pad))
    ts = np.array([0, 3, 1], np.int32)
    jnew, jplan = jmgr.batched_cloud_sync(jstates, masks, jnp.asarray(ts), jnp.int32(2))
    tnew, tplan = tmgr.batched_cloud_sync(
        tmgr.ManagerState(**{f.name: torch.from_numpy(np.array(getattr(jstates, f.name)))
                             for f in dataclasses.fields(tmgr.ManagerState)}),
        torch.from_numpy(np.array(masks)), torch.from_numpy(ts), 2)
    for f in dataclasses.fields(tmgr.SyncPlan):
        assert_equal(getattr(tplan, f.name), getattr(jplan, f.name), f.name)
    for f in dataclasses.fields(tmgr.ManagerState):
        assert_equal(getattr(tnew, f.name), getattr(jnew, f.name), f.name)

    jcodec = jpipe.session_wire_format(jt, JConfig(**CFG))[0]
    tcodec = to_torch_codec(jcodec)
    active = np.array([True, True, False])
    prio = np.array(jt.node_levels())
    union = int(np.asarray(jplan.delta_data).any(0).sum())
    budget = 1 << (int(np.log2(union)) - 1)  # about a third of the union ships
    jb = jdp.build_delta_batch(jt.gaussians, jcodec, jplan.delta_data, budget,
                               active=jnp.asarray(active), priority=jnp.asarray(prio),
                               allowance=jnp.asarray([budget, budget // 3, budget]),
                               page_size=64)
    tb = tdp.build_delta_batch(tt.gaussians, tcodec, tplan.delta_data, budget,
                               active=torch.from_numpy(active),
                               priority=torch.from_numpy(prio),
                               allowance=[budget, budget // 3, budget], page_size=64)
    assert bool(tb.overflow) and int(tb.n_shipped) == budget < int(tb.n_union) == union
    for f in ("union_gids", "n_union", "n_shipped", "ref_mask", "delivered", "deferred",
              "client_overflow", "client_pages", "pages", "row_page"):
        assert_equal(getattr(tb, f), getattr(jb, f), f)
    sh_k = jt.gaussians.sh.shape[1]
    for c in range(B):
        (tids, tdec), (jids, jdec) = (tdp.decode_client(tcodec, tb, sh_k, c),
                                      jdp.decode_client(jcodec, jb, sh_k, c))
        assert_equal(tids, jids)
        for f in ("mu", "log_scale", "quat", "opacity", "sh"):
            assert_close(getattr(tdec, f), getattr(jdec, f), 1e-6, 1e-6, f)
    assert_equal(tdp.first_owner_counts(tplan.delta_data),
                 jdp.first_owner_counts(jplan.delta_data))
    # each client's slice of the shared stream is its own per-client stream
    tpayload = tdp.decode_client(tcodec, tb, sh_k, 0)[1]
    for c, (ids, enc, ovf) in enumerate(tdp.encode_per_client(
            tt.gaussians, tcodec, tb.delivered, budget)):
        own = tb.ref_mask[c]
        assert not bool(ovf) and torch.equal(ids[ids >= 0], tb.union_gids[own])
        mine = tcomp.decode(tcodec, enc, sh_k)
        for f in ("mu", "quat", "sh"):
            assert torch.equal(getattr(mine, f)[ids >= 0], getattr(tpayload, f)[own]), f

    act = jnp.asarray(active)
    for kw in ({}, {"active": act}):
        assert_equal(tmgr.batched_wire_bytes(tplan, 29.0, **_t(kw)),
                     jmgr.batched_wire_bytes(jplan, 29.0, **kw))
    kw = dict(shared_payload=True, active=act, delivered=jb.delivered,
              client_pages=jb.client_pages)
    assert_equal(tmgr.batched_wire_bytes(tplan, 29.0, **_t(kw)),
                 jmgr.batched_wire_bytes(jplan, 29.0, **kw))
    assert_equal(tmgr.batched_wire_bytes(tplan, 29.0, shared_payload=True),
                 jmgr.batched_wire_bytes(jplan, 29.0, shared_payload=True))


# -- the service ---------------------------------------------------------------


def _run_services(trees, **wire):
    """The JAX service (pooled, XLA sweep) over a foveated walk, and both
    port schedulers over the same walk with the JAX codec and the same wire
    settings (`dedup`, `delta_budget`, `page_size`): per sync, the three
    services' stats and client cuts."""
    jt, tt = trees["small"]
    walks = _walks(4)
    cfg = JConfig(**CFG)
    js = jsvc.LodService(jt, cfg, B, focal=FOCAL, mode="pooled", taus=TAUS,
                         sweep_impl="xla", **wire)
    out = {"jax": [], "pooled": [], "vmapped": []}
    ports = {}
    for mode in ("pooled", "vmapped"):
        ports[mode] = tsvc.LodService(tt, TConfig(**CFG), B, focal=FOCAL, mode=mode,
                                      taus=TAUS, device=CPU, **wire)
        ports[mode].codec = to_torch_codec(js.codec)
    for f in range(SYNCS):
        st = js.sync(walks[f])
        out["jax"].append(({k: np.asarray(getattr(st, k)) for k in STAT_FIELDS},
                           [np.asarray(js.client_cut(c)) for c in range(B)]))
        for mode, svc in ports.items():
            st = svc.sync(walks[f])
            out[mode].append(({k: np_(getattr(st, k)) for k in STAT_FIELDS},
                              [np_(svc.client_cut(c)) for c in range(B)]))
    return js, ports, out


@pytest.fixture(scope="module")
def services(trees):
    return _run_services(trees)


def _assert_matches_jax(out, mode):
    for f, ((jst, jcuts), (tst, tcuts)) in enumerate(zip(out["jax"], out[mode])):
        for k in STAT_FIELDS:
            assert tst[k].dtype == jst[k].dtype, k
            assert_equal(tst[k], jst[k], f"sync {f}: {k}")
        for c in range(B):
            assert_equal(tcuts[c], jcuts[c], f"sync {f}: client {c}")


@pytest.mark.parametrize("mode", ["pooled", "vmapped"])
def test_service_matches_jax(services, mode):
    _js, _ports, out = services
    _assert_matches_jax(out, mode)
    assert int(out["jax"][0][0]["resweeps"].sum()) > int(out["jax"][-1][0]["resweeps"].sum())


def test_service_state_n_clients_is_the_slot_capacity(services):
    """`ServiceState.n_clients` is the slot capacity, as JAX's property."""
    js, ports, _out = services
    for svc in ports.values():
        assert svc.state.n_clients == js.state.n_clients == svc.state.capacity == B


@pytest.mark.parametrize("wire", ["unicast", "paged"])
def test_service_wire_settings_match_jax(trees, wire):
    """The other wire settings of `LodService`, both schedulers against the
    JAX service: `dedup=False` (each client charged its own unicast
    stream), and the encode-once stream under a budget below the cold
    sync's union with small pages, so rows defer and carry over as debt."""
    kw = {"unicast": dict(dedup=False),
          "paged": dict(delta_budget=1024, page_size=128)}[wire]
    js, ports, out = _run_services(trees, **kw)
    for mode in ("pooled", "vmapped"):
        _assert_matches_jax(out, mode)
    stats = [s for s, _cuts in out["jax"]]
    if wire == "unicast":
        assert all(not s["dedup_bytes_saved"].any() and not s["pages"].any()
                   for s in stats)
        assert_equal(stats[0]["delta_shipped"], stats[0]["delta_size"])
        assert ports["pooled"].last_delta is None
    else:
        assert int(stats[0]["delta_deferred"].sum()) > 0
        assert any(int(s["delta_shipped"].sum()) > 0 for s in stats[1:])


def test_service_pooled_equals_vmapped_and_delta(services):
    """Inside the port the two schedulers leave the same state, bit for bit,
    and a client's slice of the shared stream decodes like the JAX one."""
    js, ports, _out = services
    a, b = ports["pooled"].state, ports["vmapped"].state
    for x, y in zip(pytree.leaves(a), pytree.leaves(b)):
        assert torch.equal(x, y)
    for c in range(B):
        (tids, tdec), (jids, jdec) = ports["pooled"].client_delta(c), js.client_delta(c)
        assert_equal(tids, jids)
        assert_close(tdec.mu, jdec.mu, 1e-6, 1e-6)
    with pytest.raises(KeyError):
        ports["pooled"].client_cut(B)


def test_render_fallback_pooled_equals_vmap_and_jax(services):
    js, ports, _out = services
    svc = ports["pooled"]
    cams = svc._slot_cams
    jrigs = [StereoRig(left=make_camera(cams[c], cams[c] + [20.0, 15.0, -1.0],
                                        focal_px=120.0, width=96, height=64, near=0.2),
                       baseline=0.06) for c in range(B)]
    trigs = [to_torch_rig(r) for r in jrigs]
    tkernels.reset_launch_counts()
    pl, pr, pst = svc.render_fallback(trigs, list_len=128, path="pooled")
    vl, vr, vst = svc.render_fallback(trigs, list_len=128, path="vmap")
    assert sum(tkernels.launch_counts().values()) == 0  # CPU: plain versions
    assert torch.equal(pl, vl) and torch.equal(pr, vr)
    for x, y in zip(pytree.leaves(pst), pytree.leaves(vst)):
        assert torch.equal(x, y)
    assert pl.shape == (B, 64, 96, 3) and float(pl.max()) > 0
    jl, jr, jst = js.render_fallback(jrigs, list_len=128, path="vmap")
    assert_close(pl, jl, 1e-4, 1e-5)
    assert_close(pr, jr, 1e-4, 1e-5)
    for f in dataclasses.fields(jst):
        assert_equal(getattr(pst, f.name), getattr(jst, f.name), f.name)
