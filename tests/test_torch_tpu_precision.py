"""The TPU-precision witness (``tests/tpu_default_precision.py``): one port
GAN step under it rounds the operands of every conv, transposed conv and
matmul of E, G and D, forward and both gradients, and follows one JAX GAN
step whose convs and dots compute as a TPU's do at ``Precision.DEFAULT``.

The JAX side is built by substitution, the JAX package unchanged:
``lax.conv_general_dilated`` and ``lax.dot_general`` (the public name the
package calls, and the internal ones that ``jnp.dot``, ``@`` and the
transpose rules of both gradients call) take both operands as bfloat16
values held in float32 (``x.astype(bfloat16)``, passed straight through by
the gradient), so products are exact and sums and results float32: the
arithmetic of bfloat16 operands with ``preferred_element_type=float32``
(:func:`test_jax_substitute_is_bf16_operands_with_float32_products`), and a
TPU's, whose gradient ops at default precision round their operands too and
return float32.

One step of the narrow MNIST BiGAN (every width an eighth, latent 32, batch
8, ``d_updates_per_g_update=3``: an E+G update and two D updates) runs four
times from one state, batch, ``z`` and dropout masks: JAX in float32, JAX at
default precision, the port in float32, the port under the witness. One step
of the AudioMNIST BiGAN at d = 2 (its generator's dense stem included; no
dropout, no batch norm) runs three times: JAX at default precision, the port
in float32 and under the witness.
Tolerances. The two default-precision steps round the same operands, but
float32 sums in another order (batch norm's statistics differ by 1e-6
relative between the packages) put a few operands on the other side of a
bfloat16 rounding, and D's batch-norm gradients at batch 8 magnify that: in
some of D's bias gradients the two steps differ by as much as the default
precision moves them. So the gradients are held together: over all of
Adam's first moments (its gradients), the witness step lies within 0.6 of
the JAX default step's own distance from JAX's float32 step (L2; it reads
0.44), while the port's float32 step lies at 0.9 of it or more (the test
tells the two apart); each moment, first and second, within twice that
tensor's distance plus 1e-5 of its norm; the losses and D scores within
2^-8 relative.
"""
import contextlib
import dataclasses
import functools
import os
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from test_torch_gan_trainer import B, batch_for, jax_state, port_trainer, to_torch
from test_torch_gan_trainer_modes import jax_tree
from test_torch_train_layers import MaskQueue, draw_masks, narrow_config
from torch.utils._python_dispatch import TorchDispatchMode

import gan_step_trace as gst
import tpu_default_precision as tdp
from imagecfgen_tpu.models import bigan as jbigan
from imagecfgen_tpu.models import layers as jlayers
from imagecfgen_tpu.train import gan_trainer as jgt
from imagecfgen_torch.core.convert import gan_state_from_jax
from imagecfgen_torch.models import bigan as tbigan
from imagecfgen_torch.models import layers as tlayers
from imagecfgen_torch.tools import quality_battery as qb
from imagecfgen_torch.train.gan_trainer import GANTrainConfig, GANTrainer

D_UPDATES = 3


@contextlib.contextmanager
def jax_default_precision():
    """Every ``conv_general_dilated`` and ``dot_general`` traced inside it,
    forward and in both gradients, on bfloat16 values in float32. JAX's
    caches are cleared on the way in and out: ``jnp`` functions keep their
    traces by shape, so a trace made on either side of the substitution
    would otherwise serve the other (a later float32 step at the same shapes
    would round its dots)."""
    from jax._src.lax import convolution as conv_mod
    from jax._src.lax import lax as lax_mod

    conv, dot = conv_mod.conv_general_dilated, lax_mod.dot_general

    def rnd(x):
        if x.dtype != jnp.float32:
            return x
        return x + lax.stop_gradient(x.astype(jnp.bfloat16).astype(jnp.float32) - x)

    def tpu_conv(lhs, rhs, *args, **kwargs):
        return conv(rnd(lhs), rnd(rhs), *args, **kwargs)

    def tpu_dot(lhs, rhs, *args, **kwargs):
        return dot(rnd(lhs), rnd(rhs), *args, **kwargs)

    names = [(jax.lax, "conv_general_dilated", conv, tpu_conv), (conv_mod, "conv_general_dilated", conv, tpu_conv),
             (jax.lax, "dot_general", dot, tpu_dot), (lax_mod, "dot_general", dot, tpu_dot)]
    jax.clear_caches()
    for mod, name, _, new in names:
        setattr(mod, name, new)
    try:
        yield
    finally:
        for mod, name, old, _ in names:
            setattr(mod, name, old)
        jax.clear_caches()


ROUNDED_OPS = ("aten.convolution", "aten.convolution_backward", "aten.mm", "aten.addmm", "aten.bmm",
               "aten.baddbmm", "aten._convolution", "aten.cudnn_convolution", "aten.mkldnn_convolution")


class OpSpy(TorchDispatchMode):
    """Every conv and matmul the dispatcher runs: its name, whether all its
    floating operands are bfloat16 values, and whether it ran in a forward."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name in ROUNDED_OPS or "conv" in name or name.endswith("mm"):
            ops = [a for a in args if isinstance(a, torch.Tensor) and a.is_floating_point()]
            self.seen.append((name, all(torch.equal(a, tdp.round_bf16(a)) for a in ops),
                              torch._C._current_autograd_node() is None))
        return func(*args, **(kwargs or {}))


def n_convs(plan, kind="conv"):
    return sum(op[0] == kind for op in plan)


@pytest.fixture(scope="module")
def steps():
    """One step from one state, batch, ``z`` and masks, four ways."""
    jtr, st0, rng = jax_state("mnist", 0, {"d_updates_per_g_update": D_UPDATES})
    probe = port_trainer("mnist", st0, d_updates_per_g_update=D_UPDATES)
    batch = batch_for(probe.model.cfg, rng)
    masks = [draw_masks(probe.model.discriminator, n, rng) for n in probe.d_batches(B)]
    z = np.asarray(jax.random.normal(jax.random.split(st0.rng, 9)[1], (B, 1, 1, 32)))
    queue = MaskQueue()
    saved = jlayers.channel_dropout
    jlayers.channel_dropout = queue
    out = {}
    try:
        for name, ctx in (("jax_f32", contextlib.nullcontext), ("jax_default", jax_default_precision)):
            def step(st, b, m):  # a new function each time: traced afresh
                queue.masks = list(m)
                return jtr.train_step(st, b)
            with ctx():
                st1, ref = jax.jit(step)(st0, jax.tree_util.tree_map(jnp.asarray, batch),
                                         [jnp.asarray(m) for fwd in masks for m in fwd])
            assert not queue.masks
            out[name] = (gan_state_from_jax(jax_tree(st1)), {k: float(v) for k, v in ref.items()})
    finally:
        jlayers.channel_dropout = saved
    for name in ("port_f32", "port_witness"):
        tr = port_trainer("mnist", st0, d_updates_per_g_update=D_UPDATES)
        spy, counts = OpSpy(), {}
        ctx = tdp.tpu_default_precision(counts) if name == "port_witness" else contextlib.nullcontext()
        with ctx, spy:
            got = tr.train_step(to_torch(batch), z=torch.from_numpy(z),
                                masks=[[torch.from_numpy(m) for m in fwd] for fwd in masks])
        out[name] = (tr.state_dict(), {k: v.item() for k, v in got.items()})
        out[name + "_ops"] = (spy.seen, counts, tr.model.cfg)
    return out


def test_witness_rounds_every_conv_and_matmul_of_a_gan_step(steps):
    """None escapes: every conv and matmul op the step dispatched, forward
    and backward, saw bfloat16 values only; the forward ones are exactly the
    witness's wrapped calls, as many as the step's modules hold."""
    seen, counts, cfg = steps["port_witness_ops"]
    kinds = Counter((name, fwd) for name, _, fwd in seen)
    assert [s for s in seen if not s[1]] == []
    fwd_conv = kinds["aten.convolution", True]
    fwd_mm = sum(n for (name, fwd), n in kinds.items() if fwd and name in ("aten.mm", "aten.addmm", "aten.bmm"))
    assert fwd_conv == counts["conv"] + counts["conv_transpose"]
    assert fwd_mm == counts.get("matmul", 0) + counts.get("linear", 0) + counts["encoder_layer"]  # the CPU's im2col
    assert set(name for name, _ in kinds) <= {"aten.convolution", "aten.convolution_backward", "aten.mm",
                                              "aten.addmm", "aten.bmm"}
    # the step: E with a gradient and its recompute, G twice, D four times
    n_enc, n_gen = n_convs(cfg.enc_plan), n_convs(cfg.gen_plan, "convT")
    n_d = sum(n_convs(p) for p in (cfg.dx_plan, cfg.dz_plan, cfg.dxz_plan))
    assert counts["conv"] == n_enc + 4 * n_d
    assert counts["encoder_layer"] == n_enc
    assert counts["conv_transpose"] == 2 * n_gen
    assert counts["matmul"] == 2 * len(cfg.attr_spec.categorical)
    # the gradients ran through the witness: at least one conv backward for
    # each conv of the E+G update and of D's two updates, and the embedding
    # table's matmul
    assert kinds["aten.convolution_backward", False] >= n_enc + n_gen + 2 * n_d
    assert kinds["aten.mm", False] >= 1
    plain, _, _ = steps["port_f32_ops"]
    assert not all(ok for _, ok, _ in plain)  # the float32 step's operands are not bfloat16 values


def moments(state):
    return {(opt, m, n): t.float().numpy() for opt in ("opt_eg", "opt_d") for m in ("mu", "nu")
            for n, t in state[opt][m].items()}


def test_witness_step_follows_jax_at_default_precision(steps):
    truth, default = moments(steps["jax_f32"][0]), moments(steps["jax_default"][0])
    port, port_f32 = moments(steps["port_witness"][0]), moments(steps["port_f32"][0])
    for k, v in steps["jax_default"][1].items():
        np.testing.assert_allclose(steps["port_witness"][1][k], v, rtol=2.0 ** -8, err_msg=k)
    norm = lambda d: float(np.sqrt(sum(float((v ** 2).sum()) for v in d.values())))  # noqa: E731
    first = lambda d: {k: v for k, v in d.items() if k[1] == "mu"}  # noqa: E731
    effect = norm({k: first(default)[k] - truth[k] for k in first(default)})
    assert norm({k: first(port)[k] - v for k, v in first(default).items()}) <= 0.6 * effect
    assert norm({k: first(port_f32)[k] - v for k, v in first(default).items()}) >= 0.9 * effect
    for key, want in default.items():
        err, budget = np.linalg.norm(port[key] - want), np.linalg.norm(want - truth[key])
        assert err <= 2 * budget + 1e-5 * np.linalg.norm(want), f"{key}: {err:.3e} against JAX's own {budget:.3e}"


def test_round_bf16_is_round_to_nearest_even():
    v = np.array([1.0, 1 + 2 ** -8, 1 + 3 * 2 ** -8, 1 + 2 ** -9, -(1 + 2 ** -8 + 2 ** -20), 3.0e-40, np.inf],
                 np.float32)
    want = np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
    got = tdp.round_bf16(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[1] == 1.0 and got[2] == 1 + 2 ** -6  # ties to even
    x = torch.randn(64, dtype=torch.bfloat16)
    assert tdp.round_bf16(x) is x


@pytest.mark.parametrize("kind", ["conv", "dot"])
def test_jax_substitute_is_bf16_operands_with_float32_products(kind):
    rng = np.random.default_rng(1)
    if kind == "conv":
        x, w = rng.normal(size=(2, 9, 9, 6)).astype(np.float32), rng.normal(size=(3, 3, 6, 5)).astype(np.float32)
        f = lambda a, b, **k: jax.lax.conv_general_dilated(a, b, (2, 2), "SAME",  # noqa: E731
                                                           dimension_numbers=("NHWC", "HWIO", "NHWC"), **k)
    else:
        x, w = rng.normal(size=(7, 300)).astype(np.float32), rng.normal(size=(300, 5)).astype(np.float32)
        f = lambda a, b, **k: jax.lax.dot_general(a, b, (((1,), (0,)), ((), ())), **k)  # noqa: E731
    want = f(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16),
             preferred_element_type=jnp.float32)
    with jax_default_precision():
        got = f(jnp.asarray(x), jnp.asarray(w))
        g = jax.grad(lambda a: f(a, jnp.asarray(w)).sum())(jnp.asarray(x))
    assert got.dtype == jnp.float32 and g.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert not np.allclose(np.asarray(got), np.asarray(f(jnp.asarray(x), jnp.asarray(w))), rtol=1e-6, atol=0)
    # the gradient is a float32 result of bfloat16 operands, not rounded itself
    assert not np.array_equal(np.asarray(g), np.asarray(g.astype(jnp.bfloat16).astype(jnp.float32)))


SHAPES = [("conv", (2, 5, 9, 9), (4, 5, 3, 3), dict(stride=2, padding=1)),
          ("conv", (2, 8, 6, 6), (6, 8, 4, 4), dict(stride=2, padding=0)),
          ("conv_transpose", (2, 5, 3, 3), (5, 4, 3, 3), dict(stride=2, padding=0)),
          ("conv_transpose", (2, 5, 7, 7), (5, 4, 3, 3), dict(stride=2, padding=1, output_padding=1)),
          ("linear", (6, 11), (4, 11), {}), ("matmul", (6, 11), (11, 4), {})]


@pytest.mark.parametrize("kind,xs,ws,kw", SHAPES, ids=[f"{s[0]}-{i}" for i, s in enumerate(SHAPES)])
def test_wrapped_op_and_its_gradients_round_their_operands(kind, xs, ws, kw):
    """Each wrapped op equals the plain op of the rounded operands, and its
    two gradients the plain op's gradients at the rounded gradient."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(len(xs) + ws[0])
    x, w = torch.randn(xs, generator=gen), torch.randn(ws, generator=gen)
    plain = {"conv": F.conv2d, "conv_transpose": F.conv_transpose2d, "linear": F.linear, "matmul": torch.matmul}[kind]
    counts = {}
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    with tdp.TpuDefaultPrecision(counts):
        y = plain(xa, wa, **kw)
    assert counts == {kind: 1}
    g = torch.randn(y.shape, generator=gen)
    y.backward(g)
    xr, wr = tdp.round_bf16(x).requires_grad_(), tdp.round_bf16(w).requires_grad_()
    want = plain(xr, wr, **kw)
    want.backward(tdp.round_bf16(g))
    torch.testing.assert_close(y.detach(), want.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(xa.grad, xr.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(wa.grad, wr.grad, rtol=1e-6, atol=1e-6)
    assert not torch.equal(y.detach(), plain(x, w, **kw))


def test_other_matrix_products_raise_inside_the_witness():
    with tdp.TpuDefaultPrecision({}), pytest.raises(NotImplementedError, match="bmm"):
        torch.bmm(torch.ones(1, 2, 2), torch.ones(1, 2, 2))


def test_witness_restores_the_modules():
    forwards = {c: c.forward for c in (tbigan.Encoder, tbigan.Generator, tbigan.Discriminator,
                                       tlayers.AttributeVectors)}
    kernel, convs = tbigan.fused_encoder_forward, (tlayers.conv2d, tlayers.conv_transpose2d)
    dense = (tlayers.F, tlayers.fused_dense_lrelu)
    with tdp.tpu_default_precision():
        assert all(c.forward is not f for c, f in forwards.items())
        assert tbigan.fused_encoder_forward is not kernel and tlayers.conv2d is not convs[0]
        assert tlayers.F is not dense[0] and tlayers.fused_dense_lrelu is not dense[1]
    assert {c: c.forward for c in forwards} == forwards and tbigan.fused_encoder_forward is kernel
    assert (tlayers.conv2d, tlayers.conv_transpose2d) == convs and (tlayers.F, tlayers.fused_dense_lrelu) == dense


@contextlib.contextmanager
def whole_forward_witness(counts):
    """The witness as it first stood: each of E, G and D runs its whole
    forward inside :class:`tdp.TpuDefaultPrecision`, which sees every torch
    call and routes the convs and matmuls."""
    saved = [(cls, cls.forward) for cls in (tbigan.Encoder, tbigan.Generator, tbigan.Discriminator)]
    kernel = tbigan.fused_encoder_forward

    def entered(cls, forward):
        def wrapped(self, *args, **kwargs):
            if type(self) is not cls:
                return forward(self, *args, **kwargs)
            with tdp.TpuDefaultPrecision(counts):
                return forward(self, *args, **kwargs)
        return wrapped

    for cls, forward in saved:
        cls.forward = entered(cls, forward)
    tbigan.fused_encoder_forward = functools.partial(tdp.fused_encoder_by_layer, kernel, counts)
    try:
        yield
    finally:
        for cls, forward in saved:
            cls.forward = forward
        tbigan.fused_encoder_forward = kernel


def test_cut_witness_steps_as_the_whole_forward_witness_bit_for_bit():
    """The witness that routes only the convs and matmuls takes the same
    three steps as the one whose function mode saw every call of E, G and
    D: equal parameters, moments, batch-norm buffers and metrics, bit for
    bit, and the same tally of wrapped calls."""
    cfg, rng = narrow_config(tbigan, "mnist"), np.random.default_rng(3)

    def trainer():
        return GANTrainer(tbigan.BiGAN(cfg, "cpu", torch.Generator().manual_seed(3)),
                          GANTrainConfig(batch_size=B, d_updates_per_g_update=D_UPDATES), device="cpu")

    probe = trainer()
    noise = []
    for _ in range(3):
        batch = to_torch(batch_for(probe.model.cfg, rng))
        masks = [[torch.from_numpy(m) for m in draw_masks(probe.model.discriminator, n, rng)]
                 for n in probe.d_batches(B)]
        noise.append((batch, torch.from_numpy(rng.normal(size=(B, 1, 1, 32)).astype(np.float32)), masks))
    out = {}
    for name, ctx in (("whole", whole_forward_witness), ("cut", tdp.tpu_default_precision)):
        tr, counts = trainer(), {}
        with ctx(counts):
            metrics = [tr.train_step(b, z=z, masks=m) for b, z, m in noise]
        out[name] = (tr.state_dict(), metrics, counts)
    flat = lambda tree: {k: v for k, v in _leaves(tree)}  # noqa: E731
    whole, cut = flat(out["whole"][0]), flat(out["cut"][0])
    assert whole.keys() == cut.keys() and len(whole) > 40
    for k, v in whole.items():
        assert torch.equal(cut[k], v) if isinstance(v, torch.Tensor) else cut[k] == v, k
    for a, b in zip(out["whole"][1], out["cut"][1]):
        assert {k: v.item() for k, v in a.items()} == {k: v.item() for k, v in b.items()}
    assert out["whole"][2] == out["cut"][2] and out["cut"][2]["conv"] > 0


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("plan", [(("dense", 6),), (("dense", 6), ("lrelu", 0.2))], ids=["dense", "dense-lrelu"])
def test_dense_layer_and_its_gradients_round_their_operands(plan):
    """A plan's dense layer inside a witness module (a generator whose plan
    is the layer alone, its input z and one continuous attribute): the layer
    library's ``F.linear`` and ``fused_dense_lrelu`` take the rounded
    operands, and both gradients the rounded incoming gradient."""
    import torch.nn.functional as F

    from imagecfgen_torch.core.attributes import AttributeSpec

    cfg = dataclasses.replace(tbigan.audio_mnist_bigan_config(d=1, latent_dim=8), gen_plan=plan,
                              attr_spec=AttributeSpec.create(level=0))
    g = tbigan.Generator(cfg, "cpu", torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    z, level = torch.randn(3, 8, generator=gen).requires_grad_(), torch.randn(3, generator=gen)
    counts = {}
    with tdp.tpu_default_precision(counts):
        y = g(z, {"level": level})
    assert counts == {"linear": 1}
    dy = torch.randn(y.shape, generator=gen)
    y.backward(dy)
    w, b = g.trunk.dense_0_kernel, g.trunk.dense_0_bias
    feats = tdp.round_bf16(torch.cat([z.detach(), level.reshape(-1, 1)], -1))
    pre = feats @ tdp.round_bf16(w.detach()).t() + b.detach()
    want = F.leaky_relu(pre, 0.2) if len(plan) > 1 else pre
    torch.testing.assert_close(y.detach(), want, rtol=1e-6, atol=1e-6)
    gy = tdp.round_bf16(dy * (torch.where(pre >= 0, 1.0, 0.2) if len(plan) > 1 else 1.0))
    torch.testing.assert_close(w.grad, gy.t() @ feats, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(z.grad, (gy @ tdp.round_bf16(w.detach()))[:, :8], rtol=1e-6, atol=1e-6)
    plain = F.linear(torch.cat([z.detach(), level.reshape(-1, 1)], -1), w.detach(), b.detach())
    assert not torch.equal(y.detach(), F.leaky_relu(plain, 0.2) if len(plan) > 1 else plain)
    with torch.no_grad():  # outside a witness module's forward the layer is the plain one
        assert torch.equal(tlayers.F.linear(feats, w), F.linear(feats, w))


def test_audio_witness_step_follows_jax_at_default_precision():
    """One AudioMNIST BiGAN step (d = 2, latent 32, batch 8) from one state,
    batch and ``z``: the witness's step against JAX's at default precision.
    The audio BiGAN has no dropout and no batch norm, so the two round the
    same operands and part only where float32 sums in another order put an
    operand on the other side of a bfloat16 rounding. Over E's and G's Adam
    moments (the E+G update: every conv, transposed conv, dense layer and
    matmul of E, G and D, forward and backward) the witness lies within 1e-3
    of the port's float32 step's distance from JAX's default one. D's two
    updates follow E(x) and G(z) after that update, where an element whose
    gradient is rounding noise takes Adam's first step in the other
    direction (a few of G's do), so D's moments are held only nearer JAX's
    default step than float32's; the metrics within 2^-8 relative."""
    cfg_of = lambda mod: mod.audio_mnist_bigan_config(d=2, latent_dim=32)  # noqa: E731
    rng = np.random.default_rng(2)
    model = tbigan.BiGAN(cfg_of(tbigan), "cpu", torch.Generator().manual_seed(2))
    with torch.no_grad():  # O(1) activations: every kernel at unit fan-in variance
        for name, p in model.named_parameters():
            if name.endswith("_kernel"):
                p.normal_(0.0, float(np.prod(p.shape[1:] if "convT" not in name else
                                             (p.shape[0], *p.shape[2:]))) ** -0.5,
                          generator=torch.Generator().manual_seed(len(name) + p.numel()))
    jtr = jgt.GANTrainer(jbigan.BiGAN(cfg_of(jbigan)), jgt.GANTrainConfig(batch_size=B))
    pE, pG, pD = (gst.jax_params(m.state_dict()) for m in (model.encoder, model.generator, model.discriminator))
    st0 = jgt.GANState(params_E=pE, params_G=pG, vars_D={"params": pD, "batch_stats": {}},
                       opt_eg=jtr.tx_eg.init({"E": pE, "G": pG}), opt_d=jtr.tx_d.init(pD),
                       step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(2))
    batch = batch_for(cfg_of(tbigan), rng)
    z = np.asarray(jax.random.normal(jax.random.split(st0.rng, 9)[1], (B, 1, 1, 32)))
    with jax_default_precision():
        st1, ref = jax.jit(lambda st, b: jtr.train_step(st, b))(st0, jax.tree_util.tree_map(jnp.asarray, batch))
    default, ref = moments(gan_state_from_jax(jax_tree(st1))), {k: float(v) for k, v in ref.items()}
    out = {}
    for name, ctx in (("f32", contextlib.nullcontext), ("witness", tdp.tpu_default_precision)):
        tr = GANTrainer(tbigan.BiGAN(cfg_of(tbigan), "cpu"), GANTrainConfig(batch_size=B), device="cpu")
        tr.load_state_dict(gan_state_from_jax(jax_tree(st0)))
        assert all(torch.equal(v, model.state_dict()[k]) for k, v in tr.model.state_dict().items())
        counts = {}
        with ctx(counts) if name == "witness" else ctx():
            got = tr.train_step(to_torch(batch), z=torch.from_numpy(z), masks=[[], [], [], []])
        out[name] = moments(tr.state_dict()), {k: v.item() for k, v in got.items()}, counts
    counts = out["witness"][2]
    assert counts["linear"] == 2 and counts["conv_transpose"] == 2 * 5  # G's stem and deconvs, twice
    for k, v in ref.items():
        np.testing.assert_allclose(out["witness"][1][k], v, rtol=2.0 ** -8, err_msg=k)
    norm = lambda d: float(np.sqrt(sum(float((v ** 2).sum()) for v in d.values())))  # noqa: E731
    mu = lambda name, opt: {k: v - default[k] for k, v in out[name][0].items() if k[:2] == (opt, "mu")}  # noqa: E731
    assert norm(mu("witness", "opt_eg")) <= 1e-3 * norm(mu("f32", "opt_eg"))
    assert norm(mu("witness", "opt_d")) <= 0.8 * norm(mu("f32", "opt_d"))


TINY = ["--device", "cpu", "--train-glyphs", "32", "--test-glyphs", "32", "--epochs", "1", "--finetune-steps", "1",
        "--scm-steps", "1", "--clf-epochs", "1", "--vae-steps", "1", "--workers", "2"]


def test_witness_runs_the_drivers_stages_in_its_own_arm(tmp_path):
    """A tiny hard battery on the CPU, then the witness's BiGAN arm beside
    it: its own directory, DIR's SCM, classifier and VAE, the driver's
    command lines, the record's key and each stage's wrapped calls."""
    d = str(tmp_path / "D")
    assert qb.main([d, "--hard", *TINY, "--stages", "scm,clf,vae"]) == 0
    stages = "scm,clf,vae,bigan,finetune,bigan_score,generator_score,vae_score"
    assert tdp.main([d, "--hard", "--seed", "1", *TINY, "--stages", stages]) == 0
    arm = d + "_tpu_precision_seed1"
    rec = qb.load_record(os.path.join(arm, qb.RECORD))
    assert rec["tpu_precision"] == tdp.SEMANTICS and rec["dirs"]["arm"] == arm
    assert {rec["stages"][n].get("shared_from") for n in ("scm", "clf", "vae")} == {d}
    with tdp.witness_driver() as wq:
        want = {s.name: s.argv + ["--device", "cpu"] for s in wq.stages(wq.parser.parse_args(
            [d, "--hard", "--seed", "1", *TINY]))}
    ran = {k: v["argv"] for k, v in rec["stages"].items() if "argv" in v}
    assert ran == {k: want[k] for k in ran} and set(ran) == set(stages.split(",")) - {"scm", "clf", "vae"}
    calls = {k: v["tpu_precision_calls"] for k, v in rec["stages"].items() if "argv" in v}
    assert calls["bigan"]["conv"] > 0 and calls["bigan"]["conv_transpose"] > 0 and calls["bigan"]["encoder_layer"] > 0
    assert calls["bigan_score"]["encoder_layer"] > 0 and calls["generator_score"]["conv_transpose"] > 0
    assert calls["vae_score"] == {}  # the VAE is not the BiGAN's
    assert os.path.exists(os.path.join(arm, "mnist-bigan.tar")) and not os.path.exists(
        os.path.join(d + "_seed1", "mnist-bigan.tar"))
    assert qb.arm_dir(qb.parser.parse_args([d, "--seed", "1"])) == d + "_seed1"  # the driver restored


def test_audio_witness_drives_the_identity_arm_in_its_own_directory():
    """``--family audio``: ``audio_battery``'s own parser and stages with the
    float32 identity arm's flags (a flag given again takes its place), in
    ``DIR_tpu_precision_seedN``; the driver restored afterwards."""
    from imagecfgen_torch.tools import audio_battery as ab

    with tdp.witness_driver("audio") as driver:
        assert driver is ab
        args = ab.parser.parse_args(tdp.AUDIO_ARM + ["D", "--seed", "2"])
        assert ab.arm_dir(args) == os.path.abspath("D") + "_tpu_precision_seed2"
        assert (args.init_std, args.epochs) == (0.01, 1200) and not args.no_identity
        assert {"bigan", "subject_clf", "cf_classifier_metric", "cf_eval"} <= {s.name for s in ab.stages(args)}
        assert ab.parser.parse_args(tdp.AUDIO_ARM + ["--epochs", "3"]).epochs == 3
    assert ab.arm_dir(args) == os.path.abspath("D") + "_seed2"
