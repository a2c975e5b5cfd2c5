"""Train steps of the port (`parallel.train`): single-process, and
data-parallel over a `torch.distributed` process group."""

from .train import build_dp_replicated_train_step, build_gspmd_train_step

__all__ = ["build_dp_replicated_train_step", "build_gspmd_train_step"]
