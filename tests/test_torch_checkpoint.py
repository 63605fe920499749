"""The port's checkpoint module: it reads, with its own msgpack decoder, the
files that ``imagecfgen_tpu.core.checkpoint.save_checkpoint`` writes, array
for array as ``load_checkpoint(path)`` of the JAX package does; and its own
format resumes a CPU run bit for bit.

Arrays are compared exactly (the reader copies bytes); the one stated
exception is bfloat16, which numpy lacks: the port returns its exact float32
value.
"""
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gan_trainer import as_tree, batch_for, fresh_trainer, jax_state, to_torch

from imagecfgen_tpu.core import checkpoint as jckpt
from imagecfgen_tpu.scm import audio_mnist as jaudio
from imagecfgen_tpu.scm import mnist as jmnist
from imagecfgen_torch.core import checkpoint as tckpt
from imagecfgen_torch.core.convert import (
    audio_scm_from_jax_state_dict,
    gan_state_from_jax,
    scm_from_jax_state_dict,
)
from imagecfgen_torch.models import classifier as tclf
from imagecfgen_torch.train.clf_trainer import SupervisedTrainConfig, SupervisedTrainer


def assert_same_tree(got, want, path=""):
    """Same structure, same container types, equal leaves of equal dtype."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), (path, type(got), type(want))
        if str(want.dtype) == "bfloat16":
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, np.asarray(want, np.float32), err_msg=path)
        else:
            assert got.dtype == want.dtype and got.shape == want.shape, path
            np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def test_reads_a_gan_state_the_jax_package_wrote(tmp_path):
    """A ``GANState`` with its optax tuples, as ``cli.common.save_bigan``
    lays it out, after one real step (so the moments are not zeros)."""
    jtr, st, rng = jax_state("mnist", 0, {})
    batch = batch_for(jtr.model.cfg, rng)
    st, _ = jtr.jit_step(st, jax.tree_util.tree_map(jnp.asarray, batch))
    tree = {"params_E": st.params_E, "params_G": st.params_G, "vars_D": st.vars_D,
            "opt_eg": st.opt_eg, "opt_d": st.opt_d, "step": st.step, "rng": st.rng,
            "scaler": {"lo": {"thickness": np.float32(0.5)}, "hi": {"thickness": np.float64(7.0)}}}
    path = str(tmp_path / "mnist-bigan.tar")
    jckpt.save_checkpoint(path, tree, meta={"kind": "bigan", "carries_rng": True})

    want, want_meta = jckpt.load_checkpoint(path)
    got, meta = tckpt.load_checkpoint(path)
    assert meta == want_meta == tckpt.load_meta(path) == {"kind": "bigan", "carries_rng": True}
    assert_same_tree(got, want)
    assert isinstance(got["opt_eg"], tuple) and got["opt_eg"][1] == {}
    assert got["step"].dtype == np.int32 and int(got["step"]) == 1
    assert isinstance(got["scaler"]["lo"]["thickness"], np.float32)  # a numpy scalar (ext type 3)

    # and the tree carries into a port trainer: the same state as straight from memory
    direct = gan_state_from_jax(as_tree(st))
    loaded = gan_state_from_jax(got)
    tr = fresh_trainer()
    tr.load_state_dict(loaded)
    assert tr.step == 1 and tr.state_dict()["opt_d"]["count"] == 2
    for part in ("E", "G", "D"):
        for name, t in direct[part].items():
            assert torch.equal(tr.state_dict()[part][name], t), f"{part}.{name}"
    for name, t in direct["opt_eg"]["mu"].items():
        assert torch.equal(tr.state_dict()["opt_eg"]["mu"][name], t), name
    assert float(direct["opt_eg"]["nu"]["E.trunk.conv_0_kernel"].abs().max()) > 0


@pytest.mark.parametrize("domain", ["mnist", "audio"])
def test_reads_an_scm_state_dict_the_jax_package_wrote(domain, tmp_path):
    key = jax.random.PRNGKey(0)
    if domain == "mnist":
        graph = jmnist.build_mnist_graph(64.0, 255.0, -1.0, 1.0)
        scm = jmnist.MNISTAttributeSCM(graph, *graph.init(key))
    else:
        graph = jaudio.build_audio_mnist_graph()
        scm = jaudio.AudioMNISTAttributeSCM(graph, *graph.init(key))
    path = str(tmp_path / "scm.tar")
    jckpt.save_checkpoint(path, scm.state_dict(), meta={"kind": f"attribute-scm-{domain}"})
    want, _ = jckpt.load_checkpoint(path)
    got, meta = tckpt.load_checkpoint(path)
    assert meta == {"kind": f"attribute-scm-{domain}"}
    assert_same_tree(got, want)
    if domain == "mnist":
        assert isinstance(got["params"]["intensity"], tuple) and got["bounds"]["slant"] == (-1.0, 2.0)
        port = scm_from_jax_state_dict(got, device="cpu")
        np.testing.assert_array_equal(
            port.params["intensity"][0]["mlp"][0]["w"].numpy(),
            np.asarray(scm.params["intensity"][0]["mlp"][0]["w"]))
    else:
        port = audio_scm_from_jax_state_dict(got, device="cpu")
        np.testing.assert_array_equal(port.params["accent"]["mlp"][1]["w"].numpy(),
                                      np.asarray(scm.params["accent"]["mlp"][1]["w"]))


def test_reads_every_leaf_kind(tmp_path):
    """float32, int32, int64, bool and bfloat16 arrays, 0-d arrays, numpy
    scalars, python scalars, strings, None, nested tuples, a 70,000-entry map
    (map 32), a long string (str 16) and a large array (ext 32)."""
    rng = np.random.default_rng(0)
    tree = {
        "f32": rng.normal(0, 1, (3, 4)).astype(np.float32),
        "i32": np.arange(5, dtype=np.int32), "i64": np.arange(3), "flag": np.array([True, False]),
        "bf16": jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16), "zero_d": np.asarray(3.5, np.float32),
        "np_scalar": np.float32(2.5), "np_int": np.int32(-7),
        "py": {"f": 3.25, "i": 7, "neg": -3, "big": 2 ** 40, "very_neg": -2 ** 40,
               "s": "hi", "long": "x" * 300, "n": None, "t": True},
        "tup": (1.5, (np.arange(3), {"a": np.zeros(2)})),
        "wide": {f"k{i}": i for i in range(70_000)},
        "large": rng.normal(0, 1, (300, 300)),
        "empty": np.zeros((0, 3), np.float32),
    }
    path = str(tmp_path / "kinds.tar")
    jckpt.save_checkpoint(path, tree)
    want, _ = jckpt.load_checkpoint(path)
    got, meta = tckpt.load_checkpoint(path)
    assert meta == {}
    assert_same_tree(got, want)
    got["f32"][0, 0] = 1.0  # a copy the caller owns, not a view of the file's bytes


def _pack(obj) -> bytes:
    """A minimal msgpack writer for the test's hand-built payloads."""
    if isinstance(obj, dict):
        assert len(obj) < 16
        return bytes([0x80 | len(obj)]) + b"".join(_pack(k) + _pack(v) for k, v in obj.items())
    if isinstance(obj, str):
        raw = obj.encode()
        return (bytes([0xA0 | len(raw)]) if len(raw) < 32 else bytes([0xD9, len(raw)])) + raw
    if isinstance(obj, bool):
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, int):
        return bytes([obj]) if 0 <= obj < 128 else b"\xce" + struct.pack(">I", obj)
    if isinstance(obj, np.ndarray):
        shape = bytes([0x90 | obj.ndim]) + b"".join(_pack(int(d)) for d in obj.shape)
        raw = obj.tobytes()
        body = b"\x93" + shape + _pack(obj.dtype.name) + b"\xc6" + struct.pack(">I", len(raw)) + raw
        return b"\xc9" + struct.pack(">Ib", len(body), 1) + body
    raise TypeError(type(obj))


def _write(path, payload: bytes, magic=b"ICFT", meta=b"{}"):
    with open(path, "wb") as f:
        f.write(magic + struct.pack("<II", 1, len(meta)) + meta + payload)


def test_chunked_array_decodes(tmp_path):
    """flax splits arrays over 2**30 bytes into flat chunks; one built by
    hand at a small size must come back whole."""
    full = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    flat = full.reshape(-1)
    chunked = {"__msgpack_chunked_array__": True, "shape": {"0": 2, "1": 3, "2": 4},
               "chunks": {"0": flat[:10], "1": flat[10:20], "2": flat[20:]}}
    path = str(tmp_path / "chunked.tar")
    _write(path, _pack({"params": {"big": chunked, "small": np.ones(2, np.int32)}, "step": 3}))
    got, _ = tckpt.load_checkpoint(path)
    np.testing.assert_array_equal(got["params"]["big"], full)
    assert got["params"]["big"].dtype == np.float32 and got["step"] == 3
    want, _ = jckpt.load_checkpoint(path)  # the JAX package's reader agrees on the same file
    assert_same_tree(got, want)


def test_malformed_files_raise(tmp_path):
    path = str(tmp_path / "bad.tar")
    _write(path, _pack({"a": 1}), magic=b"NOPE")
    for load in (tckpt.load_checkpoint, tckpt.load_meta, lambda p: tckpt.load_train_state(p, "cpu")):
        with pytest.raises(ValueError, match="not an imagecfgen checkpoint"):
            load(path)
    _write(path, _pack({"a": 1}) + b"\x00")
    with pytest.raises(ValueError, match="after the msgpack value"):
        tckpt.load_checkpoint(path)
    _write(path, _pack({"a": np.ones(4, np.float32)})[:-3])
    with pytest.raises(ValueError, match="ends inside a value"):
        tckpt.load_checkpoint(path)
    _write(path, b"\xc1")
    with pytest.raises(ValueError, match="not supported"):
        tckpt.load_checkpoint(path)
    _write(path, b"\xd4\x02\x00")  # flax's native_complex ext: nothing the package saves
    with pytest.raises(ValueError, match="ext type 2"):
        tckpt.load_checkpoint(path)
    # a port file is not a JAX file and the other way round
    tckpt.save_train_state(path, {"step": 1})
    with pytest.raises(ValueError, match="not an imagecfgen checkpoint"):
        tckpt.load_checkpoint(path)
    assert tckpt.load_train_state(path, "cpu") == ({"step": 1}, {})


def test_gan_run_resumes_bit_for_bit(tmp_path):
    """Two steps, save, one more step; a fresh trainer that loads the file
    takes the same third step, bit for bit, from its own restored generator."""
    rng = np.random.default_rng(0)
    a = fresh_trainer(d_updates_per_g_update=2)
    batches = [to_torch(batch_for(a.model.cfg, rng)) for _ in range(3)]
    for batch in batches[:2]:
        a.train_step(batch)
    path = str(tmp_path / "run.ckpt")
    tckpt.save_train_state(path, a.state_dict(), meta={"kind": "bigan-train", "epoch": 7})
    assert tckpt.load_meta(path) == {"kind": "bigan-train", "epoch": 7}
    assert not (tmp_path / "run.ckpt.tmp").exists()
    ma = a.train_step(batches[2])

    b = fresh_trainer(seed=5, d_updates_per_g_update=2)  # other weights, other noise
    state, meta = tckpt.load_train_state(path, "cpu")
    b.load_state_dict(state)
    assert meta["epoch"] == 7 and b.step == 2
    mb = b.train_step(batches[2])
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    sa, sb = a.state_dict(), b.state_dict()
    for part in ("E", "G", "D"):
        for name in sa[part]:
            assert torch.equal(sa[part][name], sb[part][name]), f"{part}.{name}"
    for opt in ("opt_eg", "opt_d"):
        assert sa[opt]["count"] == sb[opt]["count"]
        for moment in ("mu", "nu"):
            for name in sa[opt][moment]:
                assert torch.equal(sa[opt][moment][name], sb[opt][moment][name]), name
    assert torch.equal(sa["rng"], sb["rng"]) and sa["step"] == sb["step"] == 3


def test_classifier_run_resumes_bit_for_bit(tmp_path):
    rng = np.random.default_rng(0)
    make = lambda seed: SupervisedTrainer(  # noqa: E731
        tclf.CNNClassifier(tclf.mnist_classifier_config(), "cpu", torch.Generator().manual_seed(seed)),
        SupervisedTrainConfig(batch_size=8), device="cpu", seed=seed)
    data = {"x": rng.uniform(-1, 1, (24, 28, 28, 1)).astype(np.float32),
            "y": np.eye(10, dtype=np.float32)[rng.integers(0, 10, 24)]}
    a = make(0)
    a.fit_epoch(a.upload_dataset(**data))
    path = str(tmp_path / "clf.ckpt")
    tckpt.save_train_state(path, a.state_dict())
    b = make(1)
    b.load_state_dict(tckpt.load_train_state(path, "cpu")[0])
    # the next epoch shuffles from the restored generator
    la, lb = a.fit_epoch(a.upload_dataset(**data)), b.fit_epoch(b.upload_dataset(**data))
    assert la == lb and a.step == b.step == 6
    for (n, p), (_, q) in zip(a.module.named_parameters(), b.module.named_parameters()):
        assert torch.equal(p, q), n


def test_loader_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    path = str(tmp_path / "s.ckpt")
    tckpt.save_train_state(path, {"w": torch.ones(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tckpt.load_train_state(path)
    state, _ = tckpt.load_train_state(path, device="cpu")
    assert torch.equal(state["w"], torch.ones(2))
