"""``tests/gan_step_trace.py --family audio`` at a small size: the identity
arm's BiGAN step (one D update, Adam betas (0.5, 0.9), init std 0.01) in both
packages from one JAX state, at d = 2 and batch 16 on the synthetic stand-in
cut to 4 subjects. Two steps; after the first, E, G and D lie within 1e-5
of JAX's and D(G(z)), D(E(x)) within 1e-6."""
import gan_step_trace as gst
from test_torch_cli_audio import first_subjects, one_thread  # noqa: F401  (a fixture)

from imagecfgen_tpu.data import audio_mnist as jdata


def test_audio_step_trace_follows_jax_at_step_one():
    jtr, st, tr, x, a, header, _, _ = gst.audio_setup(0, d=2, batch=16,
                                                      data=first_subjects(jdata.AudioMNISTData(None, 2)))
    assert header["betas"] == [0.5, 0.9] and header["d_updates_per_g_update"] == 1 and header["init_std"] == 0.01
    assert tr.model.cfg.init_std == 0.01 and tr.tcfg.betas == (0.5, 0.9)
    rows, _ = gst.trace(jtr, st, tr, x, a, 0, 2, log=lambda s: None, timed=True)
    assert [r["step"] for r in rows] == [1, 2] and set(rows[0]["seconds"]) == {"jax", "port"}
    assert max(rows[0]["distance"].values()) <= 1e-5
    assert all(abs(p - j) <= 1e-6 for p, j in zip(rows[0]["port"], rows[0]["jax"]))
