"""K3 on the card: the CUDA kernel against its plain PyTorch version,
and the engine's default path through it. Marked ``cuda``; every test
skips without a card. The machine with the card has no JAX, so run
these without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from kungfu_tpu_torch.ops import paged_attn as pa

pytestmark = pytest.mark.cuda

# f32: all-f32 arithmetic in another summation order; bf16: both round
# the same f32 result once, so they differ by at most one bf16 ulp
# (2**-7 = 7.8e-3 of |ref|), with atol for values near zero
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 8e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def _inputs(device, dtype, lengths, bt=16, h=12, d=64, layers=3,
            max_blocks=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    b = len(lengths)
    nb = b * max_blocks
    shape = (layers * (nb + 1), bt, h, d)
    kp = torch.randn(shape, generator=g).to(device, dtype)
    vp = torch.randn(shape, generator=g).to(device, dtype)
    q = torch.randn(b, h, d, generator=g).to(device, dtype)
    tables = (torch.randperm(nb, generator=g) + 1).reshape(b, max_blocks)
    lengths = torch.tensor(lengths, dtype=torch.int32)
    tables[lengths == 0] = 0
    return (q, kp, vp, tables.to(device, torch.int32), lengths.to(device),
            nb + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scheme", ["resident", "stream"])
def test_kernel_matches_plain_version(cuda, scheme, dtype):
    q, kp, vp, tables, lengths, nbp1 = _inputs(
        cuda, dtype, [0, 15, 16, 17, 511, 1023, 255, 700])
    pa.reset_launches()
    got = pa.paged_attention(q, kp, vp, tables, lengths,
                             block_base=nbp1, scheme=scheme)
    torch.cuda.synchronize()
    assert pa.LAUNCHES[scheme] == 1
    ref = pa.paged_attention_reference(q, kp, vp, tables, lengths,
                                       block_base=nbp1)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=rtol)


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, kp, vp, tables, lengths, _ = _inputs(cuda, torch.float32, [3, 4])
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(q, kp, vp, tables.long(), lengths)
    with pytest.raises(ValueError, match="dtype"):
        pa.paged_attention(q, kp.bfloat16(), vp.bfloat16(), tables, lengths)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(q, kp.transpose(1, 2).contiguous().transpose(
            1, 2), vp, tables, lengths)


def test_engine_default_path_launches_k3_and_no_plain(cuda):
    from kungfu_tpu_torch.serve import DecodeEngine, build_lm

    model = build_lm("tiny", 128, dtype=torch.float32, vocab_size=512)
    prompts = {i: [int(t) for t in np.random.default_rng(i).integers(
        0, 512, 5 + 7 * i)] for i in range(3)}
    runs = {}
    for kernel in ("functional", "auto"):
        eng = DecodeEngine(model, max_batch=4, block_tokens=16,
                           max_len=128, kernel=kernel)
        pa.reset_launches()
        got = {}
        for s, p in prompts.items():
            got[s] = [eng.admit(s, p, 20)[0]]
        while eng.live():
            for s, (t, _d) in eng.step()[0].items():
                got[s].append(t)
        runs[kernel] = (got, dict(pa.LAUNCHES), eng.decode_iters)
    assert runs["auto"][0] == runs["functional"][0]
    launches, iters = runs["auto"][1], runs["auto"][2]
    assert launches["resident"] == model.config.num_layers * iters
    assert launches["plain"] == 0 and launches["stream"] == 0
