"""One ring hop of ring attention over the K1 kernels — the counterparts
of `kungfu_tpu/parallel/sequence.py::_hop_flash_fwd` and
`_hop_flash_bwd`.

Ring attention is one flash computation whose K/V blocks stream over the
interconnect. Per hop the local block runs the flash forward, which
returns the block's logsumexp, and hop outputs merge by the rescale
``out = sum_h out_h * exp(lse_h - LSE)`` with ``LSE = logaddexp_h
lse_h``. For the backward, handing the flash backward the GLOBAL (out,
LSE) in place of the local residuals makes it rebuild the global
softmax restricted to the block, ``p_h = exp(s_h - LSE)``, so it returns
that hop's exact share of the gradient.

The ring loop and its collectives come with the parallel-axes slice of
the port; these two functions are the kernels' external-(o, lse) entry
point that the loop will call.
"""

from __future__ import annotations

from ..ops.flash import flash_bwd, flash_fwd


def _hop_flash_fwd(q, k_blk, v_blk, causal, scale):
    """One hop's local flash forward: ``(out [B, Ts, H, D], lse [B, H,
    Ts])``, out in q's dtype and lse in f32."""
    b, ts, h, _ = q.shape
    out, lse = flash_fwd(q, k_blk, v_blk, causal, scale, save_lse=True)
    return out, lse.reshape(b, h, ts)


def _hop_flash_bwd(q, k_blk, v_blk, out_g, lse_g, g, causal, scale):
    """One hop's gradient contribution against the GLOBAL (out, lse):
    ``(dq_h, dk_blk, dv_blk)``, all f32. `out_g` ``[B, Ts, H, D]`` and
    `lse_g` ``[B, H, Ts]`` are the fully merged ring results."""
    b, ts, h, _ = q.shape
    dq, dk, dv = flash_bwd(q, k_blk, v_blk, out_g,
                           lse_g.reshape(b * h, ts).contiguous(), g, causal,
                           scale)
    return dq.float(), dk.float(), dv.float()

