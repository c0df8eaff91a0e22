"""The port's entry points run end to end on the CPU (`--device cpu`): the
sessions two syncs each on their default 4×4-block city, the quickstart on
its 3×3-block one."""

from repro_torch.examples import multi_client_session, quickstart, vr_session


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
