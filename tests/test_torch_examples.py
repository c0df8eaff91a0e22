"""The port's entry points run end to end on the CPU (`--device cpu`): the
sessions two syncs each on their default 4×4-block city, the quickstart on
its 3×3-block one, `train_lm` a few steps of its ~100M model at a small
batch and sequence (paligemma, whose batches bring stub image embeddings)."""

from repro_torch.examples import multi_client_session, quickstart, train_lm, vr_session


def test_vr_session_runs(capsys):
    vr_session.main(["--device", "cpu", "--frames", "5", "--render-every", "4"])
    out = capsys.readouterr().out
    assert "frame   0: sync" in out and "frame   4: sync" in out
    assert "bandwidth: nebula" in out


def test_multi_client_session_runs(capsys):
    multi_client_session.main(["--device", "cpu", "--clients", "2", "--syncs", "2"])
    out = capsys.readouterr().out
    assert "sync   1:" in out and "encode-once delta path" in out
    assert "fallback render: 2 stereo frames 96x64" in out


def test_quickstart_runs(capsys):
    assert quickstart.main(["--device", "cpu"]) is True
    out = capsys.readouterr().out
    assert "bit-accurate vs independent per-eye renders: True" in out
    assert "stereo pair of shape (108, 384, 3)" in out


def test_train_lm_runs(capsys, tmp_path):
    out = train_lm.main(["--device", "cpu", "--arch", "paligemma-3b", "--steps", "4",
                         "--batch", "1", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "arch=paligemma-3b family=vlm" in text
    assert "steps run: 4  restarts: 0" in text and "median step:" in text
    assert out["final_step"] == 4 and (tmp_path / "step_00000004" / "manifest.json").exists()
