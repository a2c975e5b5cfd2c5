"""The port's whole-cluster kill and cold-boot restore, at a LARGER size
than the save: saved at np 2 (SLP, bf16 gradient compression so the
residual sidecars ride along), every worker SIGKILLed at step 5, the
cluster relaunched at np 3 against the same directory. Ranks 0 and 1
adopt their own residuals, rank 2 starts from zero (the joiner's
semantics), and the restored state beats a fresh init. Its own file, so
that `--dist loadfile` runs it beside `tests/test_torch_checkpoint.py`'s
np 1 restore."""

from test_torch_checkpoint import _restore_run


def test_whole_cluster_kill_restores_at_np3(tmp_path):
    logs = _restore_run(tmp_path, restore_np=3)
    assert "KF_CKPT_RESIDUALS rank=0 adopted" in logs
    assert "KF_CKPT_RESIDUALS rank=1 adopted" in logs
    assert "KF_CKPT_RESIDUALS rank=2 zero" in logs
    assert "KF_CONTINUITY_DONE rank=0 size=3 step=11" in logs
