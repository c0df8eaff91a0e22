"""The port's optimizer, gradient compression, train step and parameter
carry against the JAX package on the CPU (`repro_torch.train`,
`repro_torch.convert.params_to_jax`).

- `schedule`, `global_norm` and `apply_updates` on a tree with a bfloat16
  leaf, and the numpy AdamW check of `tests/test_trainer.py`.
- `compress`, `compress_grads_ef` and `wire_bytes`: int8 codes and bytes
  exactly equal.
- One `make_train_step` step from the same parameters and batch, with and
  without compression: loss, grad_norm, the new parameters, m, v and err.
- `params_from_jax ∘ params_to_jax` is the identity for every family, and
  `params_to_jax` gives JAX's keys, shapes and types.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import model_zoo as jzoo
from repro.models.config import reduced as jreduced
from repro.train import grad_compress as jgc
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import model_zoo
from repro_torch.models.config import reduced
from repro_torch.train import grad_compress as gc
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step

from _torch_parity import (flatten_tree, np_, one_torch_thread,  # noqa: F401 (a fixture)
                           randomize_constants, to_torch_model)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OCFG = dict(lr=1e-2, warmup_steps=3, total_steps=20, weight_decay=0.1, clip_norm=1.0)


def _tree(rng):
    """A float32 and a bfloat16 leaf, as numpy (float32) arrays."""
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32)}


def _jax_tree(arrays):
    return {"w": jnp.asarray(arrays["w"]), "b": jnp.asarray(arrays["b"], jnp.bfloat16)}


def _port_tree(arrays):
    return {"w": torch.from_numpy(arrays["w"].copy()),
            "b": torch.from_numpy(arrays["b"].copy()).to(torch.bfloat16)}


@pytest.mark.parametrize("step", [0, 1, 2, 3, 7, 19, 20, 25])
def test_schedule_matches_jax(step):
    for ocfg in (opt.OptimizerConfig(**OCFG), opt.OptimizerConfig(warmup_steps=0,
                                                                    total_steps=1)):
        jcfg = jopt.OptimizerConfig(**dataclasses.asdict(ocfg))
        ours = opt.schedule(ocfg, torch.tensor(step, dtype=torch.int32))
        theirs = jopt.schedule(jcfg, jnp.asarray(step, jnp.int32))
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)


def test_apply_updates_matches_jax_with_a_bf16_leaf():
    """Three AdamW steps (clipping on for the first) from the same state:
    the float32 leaf within 1e-6, the bfloat16 leaf exactly (it is cast
    back last, as in JAX), m, v and the step."""
    rng = np.random.default_rng(0)
    ocfg = opt.OptimizerConfig(**OCFG)
    jcfg = jopt.OptimizerConfig(**OCFG)
    p, jp = _port_tree(_tree(rng)), _jax_tree(_tree(np.random.default_rng(0)))
    st, jst = opt.init(p), jopt.init(jp)
    for i in range(3):
        g = _tree(rng)
        g = {k: v * (30.0 if i == 0 else 0.1) for k, v in g.items()}
        tg, jg = _port_tree(g), _jax_tree(g)
        np.testing.assert_allclose(float(opt.global_norm(tg)), float(jopt.global_norm(jg)),
                                   rtol=1e-6)
        p, st, met = opt.apply_updates(p, tg, st, ocfg)
        jp, jst, jmet = jopt.apply_updates(jp, jg, jst, jcfg)
        assert int(st.step) == int(jst.step) == i + 1 and st.step.dtype == torch.int32
        np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-6)
        assert p["b"].dtype == torch.bfloat16
        np.testing.assert_array_equal(p["b"].float().numpy(),
                                      np.asarray(jp["b"].astype(jnp.float32)))
        np.testing.assert_allclose(p["w"].numpy(), np.asarray(jp["w"]), rtol=1e-6, atol=1e-7)
        for k in ("w", "b"):
            np.testing.assert_allclose(st.m[k].numpy(), np.asarray(jst.m[k]), rtol=1e-6,
                                       atol=1e-9)
            np.testing.assert_allclose(st.v[k].numpy(), np.asarray(jst.v[k]), rtol=1e-6,
                                       atol=1e-9)


def test_optimizer_matches_numpy_reference():
    """The mirror of tests/test_trainer.py's numpy AdamW check."""
    ocfg = opt.OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=100,
                               weight_decay=0.0, clip_norm=1e9)
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 4)).astype(np.float32)
    gn = rng.normal(size=(4, 4)).astype(np.float32)
    p = {"w": torch.from_numpy(w.copy())}
    st = opt.init(p)
    opt.apply_updates(p, {"w": torch.from_numpy(gn)}, st, ocfg)
    m = 0.1 * gn
    v = 0.05 * gn * gn
    mh = m / (1 - 0.9)
    vh = v / (1 - 0.95)
    lr1 = float(opt.schedule(ocfg, 1))
    expect = w - lr1 * mh / (np.sqrt(vh) + 1e-8)
    np.testing.assert_allclose(p["w"].numpy(), expect, rtol=1e-5)


def test_compress_matches_jax_exactly():
    """Codes, scales and the dequantized values bit for bit, on gradients
    with exact halves (round half to even), an all-zero leaf and a leaf
    whose largest entry is negative; then three steps of error feedback."""
    rng = np.random.default_rng(3)
    g = rng.normal(size=(257,)).astype(np.float32)
    g[:8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 127, -127, 63.5], np.float32)
    for a in (g, np.zeros(9, np.float32), -np.abs(g) * 1e-3):
        q, s = gc.compress(torch.from_numpy(a))
        jq, js = jgc.compress(jnp.asarray(a))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(gc.decompress(q, s).numpy(),
                                      np.asarray(jgc.decompress(jq, js)))

    shapes = {"a": (3, 40), "b/c": (17,), "b/d": (2, 3, 5)}
    err = gc.init_error({k: torch.zeros(s) for k, s in shapes.items()})
    jerr = {"a": jnp.zeros(shapes["a"]), "b": {"c": jnp.zeros(shapes["b/c"]),
                                               "d": jnp.zeros(shapes["b/d"])}}
    for _ in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        jgrads = {"a": jnp.asarray(grads["a"]),
                  "b": {"c": jnp.asarray(grads["b/c"]), "d": jnp.asarray(grads["b/d"])}}
        deq, err, qerr = gc.compress_grads_ef({k: torch.from_numpy(v) for k, v in grads.items()},
                                              err)
        jdeq, jerr, jqerr = jgc.compress_grads_ef(jgrads, jerr)
        for k, v in flatten_tree(jdeq).items():
            np.testing.assert_array_equal(deq[k].numpy(), v)
        for k, v in flatten_tree(jerr).items():
            np.testing.assert_array_equal(err[k].numpy(), v)
        np.testing.assert_allclose(float(qerr), float(jqerr), rtol=1e-6)
        assert gc.wire_bytes({k: torch.from_numpy(v) for k, v in grads.items()}) == \
            jgc.wire_bytes(jgrads)


# -- one train step against JAX's -------------------------------------------------

STEP_CFG = dict(n_layers=3)        # qwen2.5 reduced: one stacked group of 3 layers


@pytest.fixture(scope="module")
def jax_step_runs():
    """JAX's train step from one seeded parameter tree and batch, with and
    without compression (the compressed run from a seeded carried error)."""
    jcfg = jreduced(JAX_ARCHS["qwen2.5-3b"], **STEP_CFG)
    jb = jzoo.get_model(jcfg)
    params, _ = jb.init(jax.random.PRNGKey(0))
    params = randomize_constants(params, np.random.default_rng(1))
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (2, 32)).astype(np.int32),
             "targets": rng.integers(0, jcfg.vocab, (2, 32)).astype(np.int32)}
    err0 = {k: (1e-3 * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in flatten_tree(params).items()}
    jocfg = jopt.OptimizerConfig(**OCFG)
    out = {}
    for compress in (False, True):
        step = jax.jit(jmake_train_step(jb, jocfg, compress))
        jerr = None
        if compress:
            jerr = jax.tree.map(lambda _p, e: jnp.asarray(e), params,
                                _unflatten(err0, params))
        p1, s1, e1, met = step(params, jopt.init(params), jerr,
                               {k: jnp.asarray(v) for k, v in batch.items()})
        out[compress] = dict(params=flatten_tree(p1), m=flatten_tree(s1.m),
                             v=flatten_tree(s1.v), err=None if e1 is None else flatten_tree(e1),
                             met={k: float(v) for k, v in met.items()})
    return dict(cfg=jcfg, params=params, batch=batch, err0=err0, runs=out)


def _unflatten(flat, like, prefix=""):
    return {k: (_unflatten(flat, v, f"{prefix}{k}/") if isinstance(v, dict)
                else flat[f"{prefix}{k}"]) for k, v in like.items()}


@pytest.mark.parametrize("compress", [False, True])
def test_train_step_matches_jax(jax_step_runs, compress):
    """Loss, grad_norm, lr and quant_err within 1e-5; m and v within 1e-4
    rtol / 1e-7 atol (they carry the gradient's float drift); err, which
    carries that drift too, within 1e-5 of the leaf's largest |gradient|. The new parameters within lr·(2e-5 +
    δ/(|g| + eps)) of JAX's, where g = m/(1 − b1) is the clipped gradient
    and δ = 1e-5 of its leaf's largest |g|: the first step moves an entry
    by lr·g/(|g| + eps) (+ weight decay), whose slope in g is below
    1/(|g| + eps), so a gradient entry near 0 (3 of 65536 embed entries
    here) moves by a different fraction of lr in each package.

    With compression, the two packages quantize gradients that differ by
    float drift, so an entry within that drift of a rounding boundary may
    take the neighbouring int8 code: its m, v, parameter and err then
    differ by one quantization step. Such flips must be one step exactly
    and at most 1e-4 of all entries; the other entries are held as above."""
    run = jax_step_runs["runs"][compress]
    cfg = reduced(get_arch("qwen2.5-3b"), **STEP_CFG)
    model = to_torch_model(jax_step_runs["params"], cfg)
    params = dict(model.named_parameters())
    state = opt.init(params)
    err = ({k: torch.from_numpy(v.copy()) for k, v in jax_step_runs["err0"].items()}
           if compress else None)
    step = make_train_step(model_zoo.get_model(cfg), opt.OptimizerConfig(**OCFG), compress)
    batch = {k: torch.from_numpy(v) for k, v in jax_step_runs["batch"].items()}
    model, state, err, met = step(model, state, err, batch)
    for key in ("loss", "grad_norm", "lr", "quant_err"):
        np.testing.assert_allclose(float(met[key]), run["met"][key], rtol=1e-5, atol=1e-9,
                                   err_msg=key)
    assert int(state.step) == 1
    if not compress:
        assert err is None and float(met["quant_err"]) == 0.0

    def stacked(tree):
        return {k: np_(t) for k, t in convert.stack_as_jax(tree, cfg).items()}

    ours = {"params": stacked({n: p.detach() for n, p in model.named_parameters()}),
            "m": stacked(state.m), "v": stacked(state.v)}
    assert set(ours["params"]) == set(run["params"])
    lr = run["met"]["lr"]
    clip = min(1.0, OCFG["clip_norm"] / max(run["met"]["grad_norm"], 1e-9))
    n_flips, n_all = 0, 0
    for k, m in run["m"].items():
        g = np.abs(m) / 0.1                      # the clipped gradient JAX's step applied
        dm = np.abs(ours["m"][k] - m)
        flip = dm > 1e-4 * np.abs(m) + 1e-7
        if compress:                             # one int8 step: max |m| is code 127's
            np.testing.assert_allclose(dm[flip], np.abs(m).max() / 127, rtol=1e-3, err_msg=k)
        else:
            assert not flip.any(), (k, ours["m"][k][flip], m[flip])
        n_flips, n_all = n_flips + int(flip.sum()), n_all + m.size
        keep = ~flip
        np.testing.assert_allclose(ours["v"][k][keep], run["v"][k][keep], rtol=1e-4, atol=1e-7,
                                   err_msg=f"v {k}")
        tol = lr * (2e-5 + 1e-5 * g.max() / (g + 1e-8))
        bad = keep & (np.abs(ours["params"][k] - run["params"][k]) > tol)
        assert not bad.any(), (k, ours["params"][k][bad], run["params"][k][bad], g[bad])
        if compress:
            e_ours, e_jax = np_(err[k]), run["err"][k]
            de = np.abs(e_ours - e_jax)
            # err = (g + err0) − deq carries the gradient's drift: 1e-5 of max |g|
            assert (de[keep] <= 1e-5 * np.abs(m).max() / (0.1 * clip)).all(), k
            np.testing.assert_allclose(de[flip], np.abs(m).max() / 127 / (0.1 * clip),
                                       rtol=1e-3, err_msg=f"err {k}")
    assert n_flips <= 1e-4 * n_all, (n_flips, n_all)
    if compress:
        assert set(err) == set(run["err"])


# -- the parameter carry -------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_params_to_jax_inverts_params_from_jax(arch):
    """On every config at reduced size (xlstm at 7 blocks, so that it has a
    group and a remainder): the port's seeded model through `params_to_jax`
    gives JAX's keys, shapes and types (`jax.eval_shape` of JAX's init: no
    allocation), and `params_from_jax` of it is the same model, bit for bit."""
    over = dict(n_layers=7) if arch == "xlstm-350m" else {}
    for dtype in ("float32", "bfloat16"):
        cfg = reduced(get_arch(arch), dtype=dtype, **over)
        jcfg = jreduced(JAX_ARCHS[arch], dtype=dtype, **over)
        model = model_zoo.get_model(cfg).init(seed=5, device="cpu")
        flat = convert.params_to_jax(model, cfg)
        shapes = jax.eval_shape(lambda: jzoo.get_model(jcfg).init(jax.random.PRNGKey(0))[0])
        want = {k: v for k, v in flatten_tree_shapes(shapes).items()}
        assert {k: a.shape for k, a in flat.items()} == {k: s for k, (s, _d) in want.items()}
        for k, a in flat.items():
            jd = np.dtype(want[k][1]) if want[k][1] != jnp.bfloat16 else np.dtype(np.float32)
            assert a.dtype == jd, (k, a.dtype, want[k][1])
        back = convert.params_from_jax(flat, cfg, "cpu")
        sa, sb = model.state_dict(), back.state_dict()
        assert list(sa) == list(sb)
        for n in sa:
            assert sa[n].dtype == sb[n].dtype
            assert torch.equal(sa[n], sb[n]), n


def flatten_tree_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_tree_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = (tuple(v.shape), v.dtype)
    return out
