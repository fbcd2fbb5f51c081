"""The yardstick's operation and byte counts against hand counts at the
published widths of qwen2.5-3b (the benchmark's configuration) and of
OLMoE-1B-7B (a mixture of experts, which the counts serve though no cell
runs it yet)."""
import json

import numpy as np
import pytest

from bench import cells, counts, weights

QWEN = counts.Shape.of(json.loads(
    (cells.HERE / "configs/qwen2.5-3b.json").read_text()))
# hf:allenai/OLMoE-1B-7B-0924 config.json
OLMOE = counts.Shape(layers=16, d_model=2048, q_heads=16, kv_heads=16,
                     head_dim=128, d_ff=1024, vocab=50304, experts=64,
                     top_k=8)


def test_weights_a_token_multiplies():
    # qwen: q/o 2048x2048, k/v 2048x256, gated MLP 3 x 2048x11008
    assert QWEN.layer_matmul_params() == 2 * 2048 * 2048 + 2 * 2048 * 256 \
        + 3 * 2048 * 11008 == 77_070_336
    # olmoe: q/k/v/o 2048x2048, router 2048x64, 8 of 64 experts
    assert OLMOE.layer_matmul_params() == 4 * 2048 * 2048 + 2048 * 64 \
        + 8 * 3 * 2048 * 1024 == 67_239_936


def test_parameter_counts_match_the_published_sizes():
    def total(shape, tied, bias):
        return sum(int(np.prod(s)) for s, _, _ in
                   weights.layout(shape, tied, bias).values())
    assert total(QWEN, True, True) == 3_085_938_688           # 3.09 B
    # 6.92 B: the published count less the QK-norms' 16 x 4096, which
    # the port leaves out
    assert total(OLMOE, False, False) == 6_919_161_856 - 16 * 4096


def test_kv_bytes_a_token():
    assert QWEN.kv_token_bytes() * QWEN.layers == 36_864
    assert OLMOE.kv_token_bytes() * OLMOE.layers == 131_072


def test_request_flops_by_hand():
    # a 4-token prompt and 3 outputs: positions 0..5 fed (the last output
    # is not fed back), keys 1+2+...+6, three unembeddings
    p = QWEN.layer_matmul_params()
    want = QWEN.layers * (2 * p * 6 + 4 * 16 * 128 * 21) \
        + 3 * 2 * 2048 * 151936
    assert counts.request_flops(QWEN, 4, 3) == want
    # the same request after a cached 2-token prefix: positions 2..5
    want2 = QWEN.layers * (2 * p * 4 + 4 * 16 * 128 * (3 + 4 + 5 + 6)) \
        + 3 * 2 * 2048 * 151936
    assert counts.request_flops(QWEN, 4, 3, start=2) == want2


def test_decode_attention_counts_a_shared_block_once():
    bs = 16
    # two live rows at cursors 20 and 35 sharing block 7; a dead row
    tables = np.array([[7, 3, 0], [7, 9, 4], [5, 6, 8]], np.int32)
    pos = np.array([20, 35, 40])
    steps = np.array([1, 1, 0])
    out = counts.Launches()
    counts.decode_attn(OLMOE, pos, steps, tables, bs, out)
    (f, b), = out.groups
    assert f == 4 * 16 * 128 * (21 + 36)
    # block 7: 16 tokens once; block 3: 5; block 9: 16; block 4: 4
    kv = (16 + 5 + 16 + 4) * 2 * 16 * 128 * 2
    assert b == 2 * 2 * 16 * 128 * 2 + kv
    # decode reads bytes far beyond its flops: bound by bandwidth
    assert out.least_s(OLMOE.layers) == pytest.approx(
        16 * b / counts.PEAK_HBM_BYTES_S)


def test_decode_window_launches_one_group_a_step():
    out = counts.Launches()
    counts.decode_attn(QWEN, np.array([10, 10]), np.array([2, 1]),
                       np.array([[1, 2], [3, 4]], np.int32), 16, out)
    assert [f for f, _ in out.groups] == [4 * 16 * 128 * 22,
                                         4 * 16 * 128 * 12]


def test_cold_prefill_by_hand():
    out = counts.Launches()
    counts.cold_prefill_attn(QWEN, 3, 2048, out)
    (f, b), = out.groups
    assert f == 3 * 4 * 16 * 128 * (2048 * 2049 // 2)
    assert b == 3 * 2048 * (2 * 16 + 2 * 2) * 128 * 2
    # 2048-token causal prefill is bound by compute
    assert out.least_s(1) == pytest.approx(f / counts.PEAK_FLOPS_BF16)


def test_suffix_prefill_chunks_by_hand():
    bs = 16
    tables = np.array([[1, 2, 3, 4], [1, 2, 5, 6]], np.int32)
    pos0 = np.array([32, 32])
    n = np.array([20, 8])
    out = counts.Launches()
    counts.suffix_prefill_attn(QWEN, pos0, n, tables, bs, 16, out)
    (f1, b1), (f2, b2) = out.groups
    assert f1 == 4 * 16 * 128 * (sum(range(33, 49)) + sum(range(33, 41)))
    assert f2 == 4 * 16 * 128 * sum(range(49, 53))
    kv_tok = 2 * 2 * 128 * 2
    # chunk 1: row 0 reads 48 tokens (blocks 1-3), row 1 40 (1, 2, 5):
    # blocks 1, 2 shared
    assert b1 == 24 * 2 * 16 * 128 * 2 + (16 + 16 + 16 + 8) * kv_tok
    assert b2 == 4 * 2 * 16 * 128 * 2 + 52 * kv_tok


def test_step_work_reads_the_closure():
    import torch
    bs, slots = 16, 4
    tables = torch.tensor([[1, 2, 0], [3, 4, 0], [0, 0, 0], [0, 0, 0]],
                          dtype=torch.int32)
    pos = torch.tensor([17, 20, 0, 0], dtype=torch.int32)
    steps = torch.tensor([1, 1, 0, 0], dtype=torch.int32)
    join = (torch.zeros((2, 64), dtype=torch.int32), None,
            torch.tensor([2, slots], dtype=torch.int32))   # one pad row
    dec, pre = counts.Launches(), counts.Launches()
    counts.step_work({"join_batch": join, "do_decode": True},
                     (None, None, None, pos, steps, tables), slots, bs, 8,
                     QWEN, dec, pre)
    ref = counts.Launches()
    counts.cold_prefill_attn(QWEN, 1, 64, ref)
    assert pre.groups == ref.groups
    assert dec.groups[0][0] == 4 * 16 * 128 * (18 + 21)
