"""The port's reference-checkpoint converter against the JAX package's tool
(``tools/convert_reference_checkpoint.py``), on the CPU.

For each state-dict kind a checkpoint in the original PyTorch ImageCFGen's
format is made from a seed (``imagecfgen_torch/tools/reference_fixtures.py``)
at narrow widths (the spectrogram BiGANs and VAEs at d = 2, the spectrogram
classifiers at width 0.25; the MNIST models at their only width). Both tools
convert it: the JAX tool in this process, with its config functions narrowed
where it fixes a width. The port reads both outputs. Checks:

- every parameter and buffer (and, for the BiGANs, both fresh Adam states)
  equal bit for bit, and one forward of the two port models equal to 1e-6;
- every reference tensor where the fixture's map says, bit for bit;
- the trunks against the reference's own ``nn.Sequential`` (built here from
  the plan, NCHW) on the same input: 1e-5 of the output's max (float32
  convolutions summed in another order);
- the whole-module convention (the reference's classes are stand-ins written
  into a temporary ``--reference-path``) gives what the state dicts give;
- the pyro-pickled attribute SCM, with junk in the masked column of the
  hypernet's first layer: parameters bit for bit, ``log_prob`` and
  ``sample_cf`` of the two port SCMs to 1e-6, and the port's ``sample_cf``
  against the JAX SCM that the JAX tool wrote to 5e-5 (the linear-rational
  spline's inverse, as in ``tests/test_torch_scm.py``); unexpected edges end
  both tools with ``SystemExit``.

Both tools install stand-in modules (``pyro``, ``librosa``, ...) for
whole-module files; the module fixture removes them afterwards.
"""
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from torch import nn

import imagecfgen_tpu.models.classifier as jclf
import imagecfgen_tpu.models.vae as jvae
from imagecfgen_torch.cli import audio_common, common, whale_common
from imagecfgen_torch.cli.convert_reference_checkpoint import convert, main
from imagecfgen_torch.core.reference import install_reference_shims
from imagecfgen_torch.models import bigan as tbigan
from imagecfgen_torch.models import classifier as tclf
from imagecfgen_torch.models import vae as tvae
from imagecfgen_torch.tools.reference_fixtures import check_mapped, reference_checkpoint
from tools.convert_reference_checkpoint import KINDS as JAX_KINDS

D, WIDTH = 2, 0.25
STUB_TOPS = ("pyro", "librosa", "torchaudio", "pytorch_msssim", "image_scms", "deepscm_vae", "attribute_scms")

# the stand-ins of the reference's modules that whole-module files name
HOLDER = '''
from torch import nn


class Holder(nn.Module):
    """A module whose state dict is the one it was built from."""

    def __init__(self, sd):
        super().__init__()
        for key, value in sd.items():
            *path, leaf = key.split(".")
            mod = self
            for p in path:
                if p not in mod._modules:
                    mod.add_module(p, nn.Module())
                mod = mod._modules[p]
            if leaf.startswith("running_") or leaf == "num_batches_tracked":
                mod.register_buffer(leaf, value.clone())
            else:
                mod.register_parameter(leaf, nn.Parameter(value.clone()))
'''
STAND_INS = {
    "image_scms/__init__.py": "",
    "image_scms/mnist.py": HOLDER + textwrap.dedent('''
        class Encoder(Holder):
            pass


        class Generator(Holder):
            pass


        class Discriminator(Holder):
            pass
        '''),
    "deepscm_vae/__init__.py": "",
    "deepscm_vae/mnist.py": "from image_scms.mnist import Holder\n\n\nclass MorphoMNISTVAE(Holder):\n    pass\n",
    "attribute_scms/__init__.py": "",
    "attribute_scms/causal_module.py": textwrap.dedent('''
        from torch import nn


        class TransformedCM(nn.Module):
            def __init__(self, td):
                super().__init__()
                self.td = td


        class ConditionalTransformedCM(nn.Module):
            def __init__(self, ctd):
                super().__init__()
                self.ctd = ctd


        class CategoricalCM(nn.Module):
            def __init__(self, d):
                super().__init__()
                self.d = d
        '''),
    "attribute_scms/graph.py": textwrap.dedent('''
        class CausalModuleGraph:
            def __init__(self):
                self.modules, self.adj = {}, {}

            def add_module(self, name, module):
                self.modules[name] = module
                self.adj.setdefault(name, [])

            def add_edge(self, u, v):
                self.adj.setdefault(u, []).append(v)
        '''),
}


@pytest.fixture(scope="module")
def reference_path(tmp_path_factory):
    """A directory of stand-in reference modules; every module, import hook
    and path entry the tools add is taken away again after the module."""
    root = tmp_path_factory.mktemp("reference")
    for rel, text in STAND_INS.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)
    modules, meta_path, path = set(sys.modules), list(sys.meta_path), list(sys.path)
    yield str(root)
    for name in set(sys.modules) - modules:
        if name.split(".")[0] in STUB_TOPS:
            del sys.modules[name]
    sys.meta_path[:], sys.path[:] = meta_path, path


def _narrowed(monkeypatch):
    """The JAX tool fixes the VAEs' and spectrogram classifiers' widths:
    narrow its config functions as the fixtures are."""
    for name in ("audio_mnist_vae_config", "whale_vae_config"):
        orig = getattr(jvae, name)
        monkeypatch.setattr(jvae, name, lambda orig=orig, **kw: orig(d=D))
    a_orig, n_orig = jclf.audio_mnist_classifier_config, jclf.narw_classifier_config
    monkeypatch.setattr(jclf, "audio_mnist_classifier_config",
                        lambda num_classes=10, width=1.0: a_orig(num_classes, width=WIDTH))
    monkeypatch.setattr(jclf, "narw_classifier_config", lambda num_classes=3, width=1.0: n_orig(num_classes, WIDTH))


def _jax_kw(kind, reference_path):
    kw = {"reference_path": reference_path}
    if kind in ("audio-bigan", "whale-bigan", "esrf-bigan", "audio-clf", "whale-clf"):
        kw["stats_prefix"] = ""
    return kw


# the port's config of each kind at the fixtures' widths, and how its files load
def _cfg(kind):
    return {
        "mnist-bigan": lambda: tbigan.mnist_bigan_config(),
        "audio-bigan": lambda: tbigan.audio_mnist_bigan_config(d=D),
        "whale-bigan": lambda: tbigan.whale_bigan_config(d=D),
        "esrf-bigan": lambda: tbigan.esrf_bigan_config(d=D),
        "mnist-vae": lambda: tvae.mnist_vae_config(),
        "audio-vae": lambda: tvae.audio_mnist_vae_config(d=D),
        "whale-vae": lambda: tvae.whale_vae_config(d=D),
        "mnist-clf": tclf.mnist_classifier_config,
        "morphomnist-oracle": tclf.mnist_oracle_config,
        "audio-clf": lambda: tclf.audio_mnist_classifier_config(10, width=WIDTH),
        "whale-clf": lambda: tclf.narw_classifier_config(width=WIDTH),
    }[kind]()


def _load(kind, path):
    """``(the model in eval mode, the trainer state or None)`` of a file of
    either package, read by the port on the CPU."""
    cfg = _cfg(kind)
    if kind.endswith("-bigan"):
        if kind == "mnist-bigan":
            state = common.load_bigan(path, "cpu")[0]
        elif kind == "audio-bigan":
            state = audio_common.load_audio_bigan(path, "cpu")[0]
        else:
            state = whale_common.load_whale_bigan(path, "cpu")[0]
        return common.bigan_from_state(state, cfg, "cpu").eval(), state
    if kind == "mnist-vae":
        return common.load_vae(path, cfg, "cpu")[0], None
    if kind.endswith("-vae"):
        return common.load_spect_vae(path, lambda meta: cfg, "cpu")[0], None
    if kind in ("mnist-clf", "morphomnist-oracle"):
        return common.load_classifier(path, cfg, "cpu"), None
    return common.load_spect_classifier(path, lambda meta: cfg, "cpu")[0], None


def _inputs(cfg, rng, b=2):
    spec = cfg.attr_spec
    attrs = {a.name: torch.nn.functional.one_hot(torch.from_numpy(rng.integers(0, a.n_categories, b)),
                                                 a.n_categories).float() for a in spec.categorical}
    attrs.update({a.name: torch.from_numpy(rng.uniform(-1, 1, b).astype(np.float32)) for a in spec.continuous})
    x = torch.from_numpy(rng.uniform(-1, 1, (b, *cfg.image_size, 1)).astype(np.float32))
    return x, attrs


def _forward(kind, model, rng):
    cfg = _cfg(kind)
    if kind.endswith("-clf") or kind == "morphomnist-oracle":
        x = torch.from_numpy(rng.uniform(-1, 1, (2, *cfg.image_size, 1)).astype(np.float32))
        with torch.no_grad():
            return [model(x)]
    x, attrs = _inputs(cfg, rng)
    z = torch.from_numpy(rng.normal(0, 1, (2, 1, 1, cfg.latent_dim)).astype(np.float32))
    with torch.no_grad():
        if kind.endswith("-bigan"):
            return [model.encoder(x, attrs), model.generator(z, attrs), model.discriminator(x, z, attrs)]
        return [*model.encoder(x, attrs), model.decoder(z, attrs)]


def _equal_states(a, b, where=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _equal_states(a[k], b[k], f"{where}/{k}")
    elif torch.is_tensor(a):
        assert a.shape == b.shape and torch.equal(a, b), where
    else:
        assert a == b, where


def _reference_sequential(plan, in_ch):
    """The reference's ``nn.Sequential`` of a plan, one index an op (NCHW)."""
    layers, c = [], in_ch
    for op in plan:
        kind = op[0]
        if kind == "conv":
            layers.append(nn.Conv2d(c, op[1], op[2], op[3], op[4]))
            c = op[1]
        elif kind == "convT":
            layers.append(nn.ConvTranspose2d(c, op[1], op[2], op[3], op[4], op[5] if len(op) > 5 else 0))
            c = op[1]
        elif kind == "dense":
            layers.append(nn.LazyLinear(op[1]))
        elif kind == "reshape":
            h, w, c = op[1]
            layers.append(nn.Unflatten(1, (c, h, w)))
        else:
            layers.append({"lrelu": lambda: nn.LeakyReLU(op[1] if len(op) > 1 else 0.01), "tanh": nn.Tanh,
                           "flatten": nn.Flatten}[kind]())
    return nn.Sequential(*layers)


def _convert(kind, tmp, reference_path, wrap=None, jax_tool=True):
    """``(fixture, map, JAX tool's file read by the port or None, port's
    file read by the port)``; ``wrap`` turns the state dicts into whole
    modules."""
    fixture, mapped = reference_checkpoint(kind, 0, d=D, width=WIDTH)
    src, out_j, out_t = (str(tmp / n) for n in ("ref.tar", "jax.tar", "port.tar"))
    torch.save(fixture if wrap is None else wrap(fixture), src)
    jax_side = None
    if jax_tool:
        with pytest.MonkeyPatch.context() as mp:
            _narrowed(mp)
            JAX_KINDS[kind](src, out_j, **_jax_kw(kind, reference_path))
        jax_side = _load(kind, out_j)
    convert(kind, src, out_t, "cpu", reference_path=reference_path)
    return fixture, mapped, jax_side, _load(kind, out_t)


@pytest.fixture(scope="module")
def converted(reference_path, tmp_path_factory):
    """Each state-dict kind converted by both tools, once for the module."""
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = _convert(kind, tmp_path_factory.mktemp(kind), reference_path)
        return cache[kind]
    return get


STATE_DICT_KINDS = [k for k in JAX_KINDS if k != "attribute-scm"]


@pytest.mark.parametrize("kind", STATE_DICT_KINDS)
def test_state_dict_kinds_match_the_jax_tool(kind, converted):
    fixture, mapped, (jm, jstate), (tm, tstate) = converted(kind)
    _equal_states(jm.state_dict(), tm.state_dict())
    if jstate is not None:  # the BiGANs: fresh Adam states and step 0 in both
        _equal_states({k: jstate[k] for k in ("opt_eg", "opt_d", "step")},
                      {k: tstate[k] for k in ("opt_eg", "opt_d", "step")})
        assert tstate["opt_eg"]["count"] == 0 and tstate["step"] == 0
        port = {p: tstate[p] for p in ("E", "G", "D")}
    else:
        port = {"module": tm.state_dict()}
    assert check_mapped(mapped, fixture, port) == len(mapped) > 0
    for a, b in zip(_forward(kind, jm, np.random.default_rng(1)), _forward(kind, tm, np.random.default_rng(1))):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-6)


def _trunk_pairs(kind, model, fixture):
    """(reference ``nn.Sequential`` holding the fixture's tensors, the port's
    trunk, input channels, input shape) of the trunks to compare."""
    cfg = _cfg(kind)
    if kind in ("mnist-clf", "audio-clf", "whale-clf"):
        return [(cfg.plan, next(iter(fixture.values())), "", model.trunk, (*cfg.image_size, 1))]
    spec = cfg.attr_spec
    in_ch = 1 + len(spec.categorical) + len(spec.continuous)
    g_in = cfg.latent_dim + cfg.embed_dim * len(spec.categorical) + len(spec.continuous)
    return [(cfg.enc_plan, fixture["E_state_dict"], "layers.", model.encoder.trunk, (*cfg.image_size, in_ch)),
            (cfg.gen_plan, fixture["G_state_dict"], "layers.", model.generator.trunk, (g_in,))]


@pytest.mark.parametrize("kind", ["mnist-clf", "audio-clf", "whale-clf", "audio-bigan"])
def test_converted_trunks_compute_the_reference_function(kind, converted):
    """The layout maps, the flatten's and the reshape's permutations and the
    transposed convs' rotation, as functions: the port's trunk on NHWC
    against the reference's ``nn.Sequential`` on NCHW."""
    fixture, _, _, (tm, _) = converted(kind)
    rng = np.random.default_rng(2)
    for plan, sd, prefix, trunk, in_shape in _trunk_pairs(kind, tm, fixture):
        x = torch.from_numpy(rng.uniform(-1, 1, (2, *in_shape)).astype(np.float32))
        seq = _reference_sequential(plan, in_shape[-1])
        x_ref = x.permute(0, 3, 1, 2) if x.dim() == 4 else x
        with torch.no_grad():
            seq(x_ref)  # sizes the lazy linear layers
            seq.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
            want, got = seq(x_ref), trunk(x)
        want = want.permute(0, 2, 3, 1) if want.dim() == 4 else want
        got = got.reshape(want.shape)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5 * max(1.0, want.abs().max().item()))


def _whole(kind):
    """The reference's other convention: whole pickled modules."""
    def wrap(fixture):
        if kind == "mnist-clf":
            seq = _reference_sequential(tclf.mnist_classifier_config().plan, 1)
            seq(torch.zeros(1, 1, 28, 28))
            seq.load_state_dict(fixture["clf"])
            return {"clf": seq}
        if kind == "mnist-vae":
            from deepscm_vae.mnist import MorphoMNISTVAE

            return {"vae": MorphoMNISTVAE(fixture["vae_state_dict"])}
        from image_scms.mnist import Discriminator, Encoder, Generator

        return {"E": Encoder(fixture["E_state_dict"]), "G": Generator(fixture["G_state_dict"]),
                "D": Discriminator(fixture["D_state_dict"])}
    return wrap


@pytest.mark.parametrize("kind", ["mnist-bigan", "mnist-vae", "mnist-clf"])
def test_whole_module_convention(kind, converted, tmp_path, reference_path, capsys):
    """The same tensors pickled as whole modules: the port's file equals the
    JAX tool's from the state dicts."""
    if reference_path not in sys.path:
        sys.path.insert(0, reference_path)
    _, _, (jm, _), _ = converted(kind)
    capsys.readouterr()
    fixture, mapped, _, (tm, tstate) = _convert(kind, tmp_path, reference_path, _whole(kind), jax_tool=False)
    assert "EXECUTES CODE" in capsys.readouterr().err  # the warning before unpickling
    _equal_states(jm.state_dict(), tm.state_dict())
    port = {p: tstate[p] for p in ("E", "G", "D")} if tstate is not None else {"module": tm.state_dict()}
    assert check_mapped(mapped, fixture, port) == len(mapped)


# ------------------------------------------------------------ the attribute SCM

N = 64


def _jax_scm():
    from imagecfgen_tpu.scm.mnist import MNISTAttributeSCM, build_mnist_graph

    rng = np.random.default_rng(0)
    graph = build_mnist_graph(64.0, 255.0, -0.9, 0.9, cond_hidden=(10,), spline="linear")
    params, state = jax.device_get(graph.init(jax.random.PRNGKey(0)))
    redraw = lambda t, s: jax.tree_util.tree_map(  # noqa: E731
        lambda a: rng.normal(0, s, np.shape(a)).astype(np.float32), t)
    params["slant"] = redraw(params["slant"], 0.7)
    params["intensity"] = redraw(params["intensity"], 0.5)
    params["thickness"] = ({"log_gamma": np.float32([0.3]), "beta": np.float32([-0.2])}, {})
    state["thickness"] = ({"mean": np.float32([2.5]), "var": np.float32([0.6])}, {})
    params["digit"] = {"logits": np.log(rng.dirichlet(np.ones(10))).astype(np.float32)}
    return MNISTAttributeSCM(graph, params, state)


def _export_pyro_scm(scm, path, reference_path, extra_edge=False):
    """A file in the reference's pickle layout of its pyro objects (as
    ``tests/test_attribute_scm_convert.py`` writes it), with the stand-in
    ``attribute_scms`` classes: pyro's unconstrained BatchNorm gamma, the
    hypernet's MaskedLinear weights with junk under a zero mask, the
    spline's ``unnormalized_*`` tensors, the digit's ``probs``."""
    install_reference_shims(reference_path)
    from attribute_scms.causal_module import CategoricalCM, ConditionalTransformedCM, TransformedCM
    from attribute_scms.graph import CausalModuleGraph

    def pyro_class(module_path, name, bases=(object,)):
        __import__(module_path)
        cls = type(name, bases, {"__module__": module_path})
        setattr(sys.modules[module_path], name, cls)
        return cls

    P, S = scm.params, scm.state
    normal = torch.distributions.Normal(torch.zeros(1), torch.ones(1))
    bn = pyro_class("pyro.distributions.transforms.batchnorm", "BatchNorm", (nn.Module,))()
    nn.Module.__init__(bn)
    bn.gamma = nn.Parameter(torch.tensor(np.exp(np.asarray(P["thickness"][0]["log_gamma"])) - 1e-6))
    bn.beta = nn.Parameter(torch.tensor(np.asarray(P["thickness"][0]["beta"])))
    bn.register_buffer("moving_mean", torch.tensor(np.asarray(S["thickness"][0]["mean"])))
    bn.register_buffer("moving_variance", torch.tensor(np.asarray(S["thickness"][0]["var"])))
    TD = pyro_class("pyro.distributions.torch", "TransformedDistribution")
    t_td = TD()
    t_td.base_dist, t_td.transforms = normal, [bn, torch.distributions.transforms.ExpTransform()]

    masked = pyro_class("pyro.nn.auto_reg_nn", "MaskedLinear", (nn.Linear,))
    mlp = P["intensity"][0]["mlp"]
    w1, w2 = np.asarray(mlp[0]["w"]), np.asarray(mlp[1]["w"])
    l1 = masked(2, w1.shape[1])
    with torch.no_grad():  # cat([context, x]): column 1 is x, junk under a zero mask
        l1.weight[:, 0] = torch.tensor(w1[0])
        l1.weight[:, 1] = 999.0
        l1.bias.copy_(torch.tensor(np.asarray(mlp[0]["b"])))
    l1.register_buffer("mask", torch.cat([torch.ones(w1.shape[1], 1), torch.zeros(w1.shape[1], 1)], dim=1))
    l2 = masked(w1.shape[1], 2)
    with torch.no_grad():
        l2.weight.copy_(torch.tensor(w2.T))
        l2.bias.copy_(torch.tensor(np.asarray(mlp[1]["b"])))
    l2.register_buffer("mask", torch.ones(2, w1.shape[1]))
    arn = pyro_class("pyro.nn.auto_reg_nn", "ConditionalAutoRegressiveNN", (nn.Module,))()
    nn.Module.__init__(arn)
    arn.layers = nn.ModuleList([l1, l2])
    caa = pyro_class("pyro.distributions.transforms.affine_autoregressive", "ConditionalAffineAutoregressive",
                     (nn.Module,))()
    nn.Module.__init__(caa)
    caa.nn = arn
    caa.log_scale_min_clip, caa.log_scale_max_clip = -5.0, 3.0
    i_aff = scm.graph.modules["intensity"].flow.chain.bijectors[2]
    i_ctd = pyro_class("pyro.distributions.conditional", "ConditionalTransformedDistribution")()
    i_ctd.base_dist = normal
    i_ctd.transforms = [caa, torch.distributions.transforms.SigmoidTransform(),
                        torch.distributions.transforms.AffineTransform(torch.tensor(i_aff.loc),
                                                                       torch.tensor(i_aff.scale))]

    sp = pyro_class("pyro.distributions.transforms.spline", "Spline", (nn.Module,))()
    nn.Module.__init__(sp)
    spp = P["slant"][0]
    for ours, theirs in (("widths", "widths"), ("heights", "heights"), ("derivs", "derivatives"),
                         ("lambdas", "lambdas")):
        setattr(sp, f"unnormalized_{theirs}", nn.Parameter(torch.tensor(np.asarray(spp[ours]))))
    sp.order, sp.bound, sp.count_bins = "linear", 3.0, spp["widths"].shape[-1]
    s_aff = scm.graph.modules["slant"].flow.chain.bijectors[1]
    s_td = TD()
    s_td.base_dist = normal
    s_td.transforms = [sp, torch.distributions.transforms.AffineTransform(torch.tensor(s_aff.loc),
                                                                          torch.tensor(s_aff.scale))]
    cat = pyro_class("pyro.distributions.torch", "Categorical")()
    cat.probs = torch.tensor(np.exp(np.asarray(P["digit"]["logits"], np.float64)))

    graph = CausalModuleGraph()
    graph.add_module("thickness", TransformedCM(t_td))
    graph.add_module("intensity", ConditionalTransformedCM(i_ctd))
    graph.add_module("slant", TransformedCM(s_td))
    graph.add_module("digit", CategoricalCM(cat))
    graph.add_edge("thickness", "intensity")
    if extra_edge:
        graph.add_edge("slant", "intensity")
    torch.save({"graph": graph}, path)


def _obs(rng):
    t = (rng.gamma(10, 1 / 5, N) + 0.5).astype(np.float32)
    i = (191 / (1 + np.exp(-(2 * t - 5))) + 64).clip(65, 254).astype(np.float32)
    return {"thickness": t.reshape(-1, 1), "intensity": i.reshape(-1, 1),
            "slant": rng.uniform(-0.85, 0.85, (N, 1)).astype(np.float32), "digit": rng.integers(0, 10, N)}


@pytest.fixture(scope="module")
def scms(reference_path, tmp_path_factory):
    from imagecfgen_tpu.cli.common import load_attribute_scm as j_load

    d = tmp_path_factory.mktemp("scm")
    src, out_j, out_t = str(d / "ref.tar"), str(d / "jax.tar"), str(d / "port.tar")
    _export_pyro_scm(_jax_scm(), src, reference_path)
    JAX_KINDS["attribute-scm"](src, out_j, reference_path=reference_path)
    assert main(["--kind", "attribute-scm", "--input", src, "--output", out_t, "--device", "cpu",
                 "--reference-path", reference_path]) == 0
    return j_load(out_j), common.load_attribute_scm(out_j, "cpu"), common.load_attribute_scm(out_t, "cpu")


def _as_torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def test_attribute_scm_parameters_match_the_jax_tool(scms):
    _, from_jax, port = scms
    flat = lambda tree: jax.tree_util.tree_flatten_with_path(tree)[0]  # noqa: E731
    a, b = flat((from_jax.params, from_jax.state)), flat((port.params, port.state))
    assert [p for p, _ in a] == [p for p, _ in b] and len(a) > 10
    for (path, x), (_, y) in zip(a, b):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), jax.tree_util.keystr(path)
    # the junk under the mask never reached the port: the first layer reads the context alone
    assert port.params["intensity"][0]["mlp"][0]["w"].shape == (1, 10)


def test_attribute_scm_log_prob_matches(scms):
    _, from_jax, port = scms
    obs = _obs(np.random.default_rng(3))
    want = from_jax.log_prob(_as_torch(obs))
    got = port.log_prob(_as_torch(obs))
    for k in want:
        assert torch.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_attribute_scm_sample_cf_matches(scms):
    """do(thickness + 2) on fully observed rows: the digit is observed and
    has no intervened ancestor, so no draw reaches the result."""
    jscm, from_jax, port = scms
    obs = _obs(np.random.default_rng(4))
    do = {"thickness": obs["thickness"] + 2}
    key = jax.random.PRNGKey(5)
    ref = jscm.sample_cf(key, obs, do)
    out = [m.sample_cf(torch.Generator().manual_seed(5), _as_torch(obs), _as_torch(do)) for m in (from_jax, port)]
    for k in ref:
        np.testing.assert_allclose(out[1][k].numpy(), out[0][k].numpy(), rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(out[1][k].numpy(), np.asarray(ref[k]), rtol=5e-5, atol=5e-5, err_msg=k)
    assert float((out[1]["intensity"] - torch.from_numpy(obs["intensity"])).mean()) > 0  # thicker, brighter


def test_attribute_scm_refuses_other_graphs(reference_path, tmp_path):
    src = str(tmp_path / "ref.tar")
    _export_pyro_scm(_jax_scm(), src, reference_path, extra_edge=True)
    with pytest.raises(SystemExit, match="unexpected SCM edges"):
        JAX_KINDS["attribute-scm"](src, str(tmp_path / "jax.tar"), reference_path=reference_path)
    with pytest.raises(SystemExit, match="unexpected SCM edges"):
        convert("attribute-scm", src, str(tmp_path / "port.tar"), "cpu", reference_path=reference_path)

