"""``tests/gan_step_trace.py --family audio`` at a small size: the identity
arm's BiGAN step (one D update, Adam betas (0.5, 0.9), init std 0.01) in both
packages from one JAX state, at d = 2 and batch 16 on the synthetic stand-in
cut to 4 subjects. Two steps; after the first, E, G and D lie within 1e-5
of JAX's and D(G(z)), D(E(x)) within 1e-6. ``--bisect``'s step 1 against
float64, at the same size."""
import gan_step_trace as gst
import pytest
from test_torch_cli_audio import first_subjects, one_thread  # noqa: F401  (a fixture)

from imagecfgen_tpu.data import audio_mnist as jdata


@pytest.fixture(scope="module")
def audio():
    """Both packages' trainers from one JAX state (``audio_setup``)."""
    return gst.audio_setup(0, d=2, batch=16, data=first_subjects(jdata.AudioMNISTData(None, 2)))


def test_audio_step_trace_follows_jax_at_step_one(audio):
    jtr, st, tr, x, a, header, _, _ = audio
    assert header["betas"] == [0.5, 0.9] and header["d_updates_per_g_update"] == 1 and header["init_std"] == 0.01
    assert tr.model.cfg.init_std == 0.01 and tr.tcfg.betas == (0.5, 0.9)
    rows, _ = gst.trace(jtr, st, tr, x, a, 0, 2, log=lambda s: None, timed=True)
    assert [r["step"] for r in rows] == [1, 2] and set(rows[0]["seconds"]) == {"jax", "port"}
    assert max(rows[0]["distance"].values()) <= 1e-5
    assert all(abs(p - j) <= 1e-6 for p, j in zip(rows[0]["port"], rows[0]["jax"]))


def test_bisect_takes_step_one_apart_against_float64(audio):
    """``--bisect`` at d = 2 and batch 16: every parameter of E, G and D has
    a row in each gradient that reaches it; both packages' gradients and
    pre-activations lie near float64 and each other; and the float64 forwards
    in float32 are the port modules' own, bit for bit."""
    import torch

    import fault_verdicts as fv

    tr = audio[2]
    entry = gst.bisect(*audio, log=lambda s: None)
    names = {part: {n for n, _ in getattr(tr.model, mod).named_parameters()}
             for part, mod in (("E", "encoder"), ("G", "generator"), ("D", "discriminator"))}
    rows = {u: {(t["part"], t["tensor"]) for t in entry["tensors"] if t["update"] == u}
            for u in ("EG", "D_real", "D_fake")}
    assert rows["EG"] == {(p, n) for p in "EG" for n in names[p]}
    assert rows["D_real"] == rows["D_fake"] == {("D", n) for n in names["D"]}
    assert all(t["jax"] < 1e-4 and t["port"] < 1e-4 and t["port_vs_jax"] < 1e-4 for t in entry["tensors"])
    kinked = {(u, t) for u, t in ((r["update"], r["tower"]) for r in entry["layers"])}
    assert ("EG", "D_fake.dx") in kinked and ("D_fake", "D.dz") in kinked and ("EG", "G.trunk") in kinked
    assert all(r["error"]["jax"] < 1e-5 and r["error"]["port"] < 1e-5 for r in entry["layers"])
    assert set(entry["step1_parts"]) == {"E", "G", "D"} and entry["step1_distance"]["D"] < 1e-5

    def flips(update, tower):
        return sum(r["kink_flips"]["jax"] + r["kink_flips"]["port"] for r in entry["layers"]
                   if r["update"] == update and r["tower"] == tower)

    def row(update, tensor):
        return next(t for t in entry["tensors"] if t["update"] == update and t["tensor"] == tensor)

    # a tensor's path: its own layer, those after it in its tower, and every tower below
    assert row("D_real", "dx.conv_5_kernel")["kink_flips_on_path"] == flips("D_real", "D.dxz")
    assert row("D_fake", "attr_channels.embed_digit")["kink_flips_on_path"] == (
        flips("D_fake", "D.dx") + flips("D_fake", "D.dxz"))
    assert row("EG", "trunk.conv_5_kernel")["kink_flips_on_path"] == (
        flips("EG", "D_real.dz") + flips("EG", "D_real.dxz"))
    assert fv.audio_step_bisect_verdict(entry["tensors"], entry["step1_parts"]) in ("rounding", "unresolved")

    # the float64 forwards run in float32 on the port's own parameters are its modules' forwards
    enc, gen, disc = gst.bigan_forwards(tr.model.cfg)
    m = tr.model
    p = {part: {k: v.detach() for k, v in getattr(m, mod).named_parameters()}
         for part, mod in (("E", "encoder"), ("G", "generator"), ("D", "discriminator"))}
    x, attrs = torch.from_numpy(audio[3][:4]), {k: torch.from_numpy(v[:4]) for k, v in audio[4].items()}
    z = torch.randn(4, 1, 1, m.cfg.latent_dim, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(enc(p, x, attrs)[0], m.encoder.trunk(m.encoder.attr_channels(x, attrs)).reshape(4, 1, 1, -1))
        assert torch.equal(gen(p, z, attrs)[0], m.generator(z, attrs))
        assert torch.equal(disc(p, x, z, attrs)[0], m.discriminator(x, z, attrs))
