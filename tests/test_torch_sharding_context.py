"""The sharding context (`repro_torch.sharding.context`) against
`repro.sharding.context`, and the models on a 1×1 mesh.

- `activation_rules` equals JAX's, for a mesh stand-in with sizes, for bare
  axis names, and for a `DeviceMesh`.
- With no rules set, `constrain` and `bshard` return their input; under
  rules, a plain tensor too (there is no mesh to place it on).
- On a 1×1 mesh in this process (a world of one gloo rank), one config of
  every family at `reduced` size, its parameters placed by
  `make_shardings` and run under the mesh's activation rules: the prefill
  logits, a decode step's logits and the loss equal the meshless model's
  bit for bit.
- MoE's per-group dispatch: granite-moe's `moe_mlp` at reduced size under
  rules whose `batch` axis has size 2 sorts in two groups, as JAX's does
  under the same rules (JAX on a 1×1 `Mesh` of the one CPU device): each
  group's routing, slots and drops exactly as a numpy derivation from
  JAX's routing, the output within 1e-6 of JAX's.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import ARCHS as JARCHS
from repro.models import moe as jmoe
from repro.models.config import reduced as jreduced
from repro.sharding import context as jctx
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import destroy_fleet_group, init_fleet_group, make_mesh
from repro_torch.models import model_zoo, moe
from repro_torch.models.config import reduced
from repro_torch.models.layers import param_axes
from repro_torch.sharding import context as ctx
from repro_torch.sharding.partitioning import (LOGICAL_RULES, make_shardings, shard_module,
                                               shard_tree)

from _torch_parity import CPU, assert_close, assert_equal, to_torch_model

FAMILY_ARCHS = ["qwen2.5-3b", "paligemma-3b", "granite-moe-1b-a400m", "seamless-m4t-medium",
                "zamba2-2.7b", "xlstm-350m"]


@pytest.mark.parametrize("shape,names", [((16, 16), ("data", "model")),
                                         ((2, 16, 16), ("pod", "data", "model")),
                                         ((1, 1), ("data", "model"))])
def test_activation_rules_match_jax(shape, names):
    port = ctx.activation_rules(SimpleNamespace(axis_names=names, shape=dict(zip(names, shape))))
    ref = jctx.activation_rules(SimpleNamespace(axis_names=names, devices=np.empty(shape)))
    assert port == ref
    assert ctx.activation_rules(names) == jctx.activation_rules(names)
    assert ctx.activation_rules(names, seq_parallel=False) == \
        jctx.activation_rules(names, seq_parallel=False)


def test_constrain_and_bshard_without_rules_are_the_identity():
    x = torch.randn(2, 8, 4)
    assert ctx.current_rules() is None
    assert ctx.bshard(x) is x
    assert ctx.constrain(x, ("batch", None, "embed_act")) is x
    rules = ctx.activation_rules(SimpleNamespace(axis_names=("data", "model"),
                                                 shape={"data": 2, "model": 2}))
    with ctx.use_rules(rules):
        assert ctx.current_rules() is rules
        assert ctx.bshard(x) is x
        assert ctx.constrain(x, ("batch", "seq_act", None)) is x
    assert ctx.current_rules() is None


@pytest.fixture(scope="module")
def mesh11(tmp_path_factory):
    """A 1×1 ("data", "model") mesh over a world of this one process."""
    init_fleet_group(str(tmp_path_factory.mktemp("ctx") / "store"), 0, 1, "gloo", device=CPU)
    try:
        yield make_mesh((1, 1), ("data", "model"), device=CPU)
    finally:
        destroy_fleet_group()


def test_activation_rules_of_a_device_mesh(mesh11):
    assert ctx.activation_rules(mesh11) == jctx.activation_rules(
        SimpleNamespace(axis_names=("data", "model"), devices=np.empty((1, 1))))


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _inputs(cfg, seed=1):
    g = torch.Generator().manual_seed(seed)
    b, s = 2, 16
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g),
             "targets": torch.randint(0, cfg.vocab, (b, s), generator=g)}
    for k, shp in model_zoo.stub_shapes(cfg, s).items():
        batch[k] = torch.randn((b,) + shp, generator=g)
    return batch


def _run(bundle, model, batch, place):
    cfg = bundle.cfg
    prompt = place({k: v for k, v in batch.items() if k != "targets"})
    logits, cache = bundle.prefill(model, prompt, max_len=20 + (cfg.n_img_tokens or 0))
    step, _cache = bundle.decode_step(model, cache, place({"token": batch["tokens"][:, 0]}))
    loss = bundle.loss(model, place(batch))
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True,
                                materialize_grads=True)
    return [_local(logits), _local(step), _local(loss)] + [_local(g) for g in grads]


@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_families_on_a_1x1_mesh_are_bitwise(name, mesh11):
    cfg = reduced(ARCHS[name])
    bundle = model_zoo.get_model(cfg)
    batch = _inputs(cfg)
    ref = _run(bundle, bundle.init(seed=0, device=CPU), batch, lambda b: b)

    model = bundle.init(seed=0, device=CPU)
    shard_module(model, mesh11, make_shardings(mesh11, dict(model.named_parameters()),
                                               param_axes(model)))
    assert all(hasattr(p, "placements") for p in model.parameters())

    def place(b):
        axes = {k: ("batch",) + (None,) * (v.ndim - 1) for k, v in b.items()}
        return shard_tree(b, mesh11, make_shardings(mesh11, b, axes, dict(LOGICAL_RULES)))

    with ctx.meshed(ctx.activation_rules(mesh11)):
        got = _run(bundle, model, batch, place)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.dtype == b.dtype and torch.equal(a, b), (name, i, float((a - b).abs().max()))


def _granite():
    jcfg = dataclasses.replace(jreduced(JARCHS["granite-moe-1b-a400m"]), capacity_factor=1.0)
    cfg = dataclasses.replace(reduced(ARCHS["granite-moe-1b-a400m"]), capacity_factor=1.0)
    return jcfg, cfg


@pytest.fixture(scope="module")
def moe_case():
    jcfg, cfg = _granite()
    params = jax.jit(lambda key: jmoe.init(key, jcfg)[0])(jax.random.PRNGKey(3))
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    mlp = to_torch_model(params, cfg).layers[0].mlp
    x = np.random.default_rng(5).normal(size=(4, 32, cfg.d_model)).astype(np.float32)
    rules = {**jctx.activation_rules(("data", "model")), "__sizes__": {"data": 2, "model": 1}}
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))

    def routed(xj, p):
        out, aux = jmoe.moe_mlp(xj, p, jcfg)
        probs = jax.nn.softmax(xj.reshape(2, -1, cfg.d_model) @ p["router"], -1)
        return out, aux, jax.lax.top_k(probs, cfg.top_k)[1]

    with mesh, jctx.use_rules(rules):       # the rules are read as JAX traces
        jout, jaux, je = jax.jit(routed)(jnp.asarray(x), lp)
    return dict(cfg=cfg, mlp=mlp, x=x, rules=rules, jout=np.asarray(jout),
                jaux=float(jaux), je=np.asarray(je))


def _slots_np(top_e: np.ndarray, cap: int, e: int) -> np.ndarray:
    """Each (token, k) assignment's slot in its group's buffer, from the
    routing alone: expert·cap + its place among the expert's assignments
    in order of (token, k), or e·cap past the first cap."""
    g, n, k = top_e.shape
    flat = top_e.reshape(g, n * k)
    out = np.full((g, n * k), e * cap, np.int64)
    for gi in range(g):
        seen = np.zeros(e, np.int64)
        for a, ex in enumerate(flat[gi]):
            if seen[ex] < cap:
                out[gi, a] = ex * cap + seen[ex]
            seen[ex] += 1
    return out


def test_moe_two_group_dispatch_matches_jax(moe_case):
    cfg, mlp, x, rules = (moe_case[k] for k in ("cfg", "mlp", "x", "rules"))
    n = x.shape[0] * x.shape[1]
    with ctx.use_rules(rules):
        assert moe._n_data_groups() == 2
        with torch.no_grad():
            out, aux = moe.moe_mlp(torch.from_numpy(x), mlp, cfg)
    _p, _w, top_e = moe.route(torch.from_numpy(x).reshape(2, n // 2, -1), mlp.router, cfg.top_k)
    assert_equal(top_e, moe_case["je"])
    cap = moe.capacity(n // 2, cfg)
    slot, disp_tok = moe.dispatch(top_e, cap, cfg.n_experts)
    want = _slots_np(moe_case["je"], cap, cfg.n_experts)
    assert_equal(slot, want)
    assert (want == cfg.n_experts * cap).sum() > 0, "no assignment dropped: a weak case"
    for gi in range(2):          # each filled row names its token; empty rows n_loc
        kept = want[gi] < cfg.n_experts * cap
        rows = np.full(cfg.n_experts * cap, n // 2)
        rows[want[gi][kept]] = np.nonzero(kept)[0] // cfg.top_k
        assert_equal(disp_tok[gi], rows)
    assert_close(out, moe_case["jout"], 1e-6, 1e-6, "moe_mlp, 2 groups")
    assert abs(float(aux) - moe_case["jaux"]) <= 1e-6
    with torch.no_grad():       # one group sorts the same tokens otherwise
        one, _ = moe.moe_mlp(torch.from_numpy(x), mlp, cfg)
    assert not torch.equal(one, out)


def test_moe_two_group_dispatch_on_a_mesh_matches_jax(moe_case, mesh11, monkeypatch):
    """The form a placed model runs (`moe._moe_mlp_sharded`, three
    `local_map`s) under the same two-group rules: on the 1×1 mesh one rank
    holds both groups. Its slots and drops (read from `moe.dispatch`) and
    its output and aux are held to JAX's as the plain form's are."""
    cfg, mlp, x, rules = (moe_case[k] for k in ("cfg", "mlp", "x", "rules"))
    n = x.shape[0] * x.shape[1]
    cap = moe.capacity(n // 2, cfg)
    placed = moe.MoEMLP(cfg, torch.float32, CPU, torch.Generator().manual_seed(0))
    placed.load_state_dict(mlp.state_dict())
    shard_module(placed, mesh11, make_shardings(mesh11, dict(placed.named_parameters()),
                                                param_axes(placed)))
    xd = shard_tree({"x": torch.from_numpy(x)}, mesh11,
                    make_shardings(mesh11, {"x": torch.from_numpy(x)},
                                   {"x": ("batch", None, None)}, dict(LOGICAL_RULES)))["x"]
    seen, real_dispatch = [], moe.dispatch
    monkeypatch.setattr(moe, "dispatch", lambda *a: seen.append(real_dispatch(*a)) or seen[-1])
    with ctx.meshed(rules), torch.no_grad():
        out, aux = moe.moe_mlp(xd, placed, cfg)
    assert hasattr(out, "placements") and len(seen) == 1
    slot, _disp_tok = seen[0]
    want = _slots_np(moe_case["je"], cap, cfg.n_experts)
    assert slot.shape == want.shape == (2, n // 2 * cfg.top_k)
    assert_equal(slot, want)
    assert_close(_local(out), moe_case["jout"], 1e-6, 1e-6, "moe_mlp on a mesh, 2 groups")
    assert abs(float(_local(aux)) - moe_case["jaux"]) <= 1e-6
