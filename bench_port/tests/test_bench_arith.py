"""The yardstick's arithmetic against shapes worked by hand: the kernels'
counts (PERF.md's kernel table shapes), the roofline share, the shares of
the peak and the trace's idle reading."""

import types

import pytest

import checkout  # noqa: F401
from benchlib import roofline as R
from benchlib import trace as T
from benchlib import work as W
from benchlib import spec

HBM, BF16 = 3.35e12, 989e12
QWEN, _ = spec.families("qwen2_audio")


def test_k1_causal_prefill_counts():
    # (4, 32, 1024, 128), every row valid: 4 * 1024 * 1025 / 2 pairs a head
    flops, nbytes = R.attention_fwd(32, 32, 128, 4 * 1024, 4 * 524800, 4 * 1024)
    assert flops == 34_393_292_800
    assert nbytes == 134_217_728  # q, o, k, v: 4 * 4096 rows * 32 heads * 128 * 2 B
    assert R.bound_seconds(flops, nbytes) == pytest.approx(134_217_728 / HBM)


def test_k2_tower_counts_valid_keys():
    # (24, 20, 1500, 64), 100 valid frames a clip: 100 x 100 pairs a head
    work = R.Work()
    cfg = {"audio_config": {"num_mel_bins": 128, "d_model": 1280, "encoder_layers": 1,
                            "encoder_attention_heads": 20, "encoder_ffn_dim": 5120,
                            "max_source_positions": 1500},
           "text_config": {"hidden_size": 3584, "num_hidden_layers": 1, "num_attention_heads": 28,
                           "num_key_value_heads": 4, "intermediate_size": 18944,
                           "vocab_size": 156032},
           "audio_pool_stride": 2}
    QWEN.tower(cfg, work, [100] * 24)
    op = work.ops["tower_attention"]
    assert op[0] == 1_228_800_000  # 4 * 64 * 20 * 24 * 10000
    assert op[1] == 24_576_000  # 24 clips * 4 * 100 rows * 20 * 64 * 2 B
    assert op[2] == pytest.approx(max(1_228_800_000 / BF16, 24_576_000 / HBM))


def test_k7_q8_decode_counts():
    # a 13B int8 cache row: 40 heads of 128, 900 cached positions
    flops, nbytes = R.decode_attention_q8(40, 40, 128, 900)
    assert flops == 18_452_480  # 4 * 128 * 40 * 901
    assert nbytes == 9_544_960  # int8 k, v + f32 scales; q, o, new k, v in bf16


def test_k10_int4_counts():
    # 13B w_gate 5120 x 13824, M = 4, group 128: the packed bytes read once
    flops, nbytes = R.qmatmul(4, 5120, 13824, 4, 128)
    assert flops == 566_231_040
    assert nbytes == 35_389_440 + 2_211_840 + 151_552
    assert R.bound_seconds(flops, nbytes) * 1e3 == pytest.approx(0.01127, abs=1e-5)


def test_share_counts_only_ops_whose_kernels_ran():
    work = {"a": {"bound_s": 1.0}, "b": {"bound_s": 5.0}}
    opmap = {"a": ["ka<1"], "b": ["kb"]}
    kernels = {"void ka<1, 2>(x)": 4.0, "other": 9.0}
    assert R.share(["a", "b"], work, kernels, opmap) == pytest.approx(25.0)
    assert R.share(["b"], work, kernels, opmap) is None


def test_model_flops_of_a_prefill():
    cfg = {"audio_config": {"num_mel_bins": 8, "d_model": 8, "encoder_layers": 1,
                            "encoder_attention_heads": 2, "encoder_ffn_dim": 32,
                            "max_source_positions": 1500},
           "text_config": {"hidden_size": 8, "num_hidden_layers": 2, "num_attention_heads": 2,
                           "num_key_value_heads": 1, "intermediate_size": 16, "vocab_size": 10},
           "audio_pool_stride": 2}
    work = R.Work()
    W.decoder_prefill(cfg, QWEN.dims(cfg), work, [3])
    # a layer: wq 64, wk 32, wv 32, wo 64, gate/up/down 3 * 128; attention 4*4*2*6
    per_layer = 2 * 3 * (64 + 32 + 32 + 64 + 384) + 4 * 4 * 2 * 6
    assert work.model_flops == 2 * per_layer + 2 * 8 * 10


def test_metric_readers():
    cell = spec.load("qwen2a-bf16.eval-speech-k5")
    readers = {m.name: m.reader for m in cell.end_to_end + cell.per_layer}
    rec = {"loop": "eval", "setup_s": 20.0, "window_s": 30.0, "utterances": 240, "batches": 15,
           "peak_bytes": 3 * 2 ** 30, "step_ms": [[100.0, 50.0, 70.0], [120.0, 60.0]],
           "syncs": 45, "model_flops": 989e12 * 3, "work": {}, "launches": {}, "opmap": cell.opmap,
           "trace": {"busy_s": 24.0, "window_s": 30.0, "kernel_s": {}}}
    assert readers["eval_utt_per_s"].read(rec) == 8.0
    assert readers["peak_mem_gib"].read(rec) == 3.0
    assert readers["prefill_ms.eval"].read(rec) == 110.0
    assert readers["decode_step_ms.eval"].read(rec) == 60.0
    assert readers["syncs_per_batch.eval"].read(rec) == 3.0
    assert readers["mfu.eval"].read(rec) == pytest.approx(10.0)
    assert readers["device_idle_pct.eval"].read(rec) == pytest.approx(20.0)
    assert readers["attention_roofline.eval"].read(rec) is None


class _Event:
    def __init__(self, name, start_us, dur_us, cuda):
        self._n, self._s, self._d, self._c = name, start_us, dur_us, cuda

    def name(self):
        return self._n

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._s * 1000

    def duration_ns(self):
        return self._d * 1000


def test_trace_summary_busy_and_gaps():
    events = [_Event("bench/window", 0, 100, False), _Event("bench/collate", 0, 30, False),
              _Event("bench/generate", 30, 70, False), _Event("k1", 10, 20, True),
              _Event("k2", 25, 10, True), _Event("k1", 60, 20, True)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    s = T.summarize(prof)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(45e-6)  # [10, 35) and [60, 80)
    assert s["kernel_s"]["k1"] == pytest.approx(40e-6)
    assert [g[0] for g in s["idle_gaps"]] == ["generate", "generate", "collate"]
    assert s["idle_gaps"][0][1] == pytest.approx(25e-6)
