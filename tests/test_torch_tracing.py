"""The port's spans and device intervals (``utils/perf.py``): ``span``
with and without a profiler, the ``port/`` ranges that a
Qwen2-Audio engine batch, a train step and the collate put on the
profiler's timeline, and the layout of the engine's and the step's
intervals, on the CPU (CUDA events replaced by host-clock marks)."""

import time

import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu_torch import registry as tregistry
from icl_speech_text_llm_tpu_torch.data import factory as tdata
from icl_speech_text_llm_tpu_torch.data.collate import collate_icl_batch
from icl_speech_text_llm_tpu_torch.data.packing import PackConfig
from icl_speech_text_llm_tpu_torch.inference import engine as tengine
from icl_speech_text_llm_tpu_torch.models import factory as tfactory
from icl_speech_text_llm_tpu_torch.models import qwen_audio as tqa
from icl_speech_text_llm_tpu_torch.training import loop as tloop
from icl_speech_text_llm_tpu_torch.training import step as tstep
from icl_speech_text_llm_tpu_torch.utils import perf
from icl_speech_text_llm_tpu_torch.utils.tokenization import get_tokenizer

torch.set_num_threads(1)

K = 1  # exemplars a prompt
MAX_NEW = 4


class _HostEvent:
    """A CUDA event's surface on the host's clock."""

    def __init__(self):
        self.t = time.perf_counter()
        self.waited = False

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3

    def synchronize(self):
        self.waited = True


class _HostEvents(perf.StepEvents):
    def mark(self):
        self.events.append(_HostEvent())


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _ranges(prof, caller="caller"):
    """(start, end, name) of every ``port/`` range and of ``caller``, by start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(perf.SPAN_PREFIX) or e.name() == caller:
            out.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    return sorted(out)


def _in_order_within_caller(ranges, names):
    """The ranges are ``caller`` then ``names`` in that order, one after
    another, each inside the caller."""
    assert [n for _, _, n in ranges] == ["caller"] + [perf.SPAN_PREFIX + n for n in names]
    c0, c1, _ = ranges[0]
    inner = ranges[1:]
    for (s, e, n) in inner:
        assert c0 <= s <= e <= c1, n
    for (_, e, n), (s, _, m) in zip(inner, inner[1:]):
        assert e <= s, (n, m)


@pytest.fixture(scope="module")
def qwen():
    """qwen2-audio-tiny on the CPU with two packed Qwen-format requests."""
    gen = tengine.GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-1, pad_token_id=0)
    model = tfactory.create_model("qwen2-audio-tiny", seed=0, device="cpu", generation=gen)
    pack = PackConfig(seq_len=2048, text_len=512, max_slots=K + 1, audio_tokens_per_slot=750,
                      audio_len_fn=tqa.audio_output_length)
    ds = tdata.create_dataset(
        tregistry.DatasetType.VOXCELEB, split=tregistry.DatasetSplit.TEST,
        input_mode="speech_only", fewshot_mode="speech", num_examples=K, max_samples=2,
        synthetic=True, synthetic_size=4, seed=3, prompt_style="qwen")
    samples = [ds[i] for i in range(2)]
    return model, pack, samples


def test_span_records_nothing_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = perf.span("a"), perf.span("b")
    assert a is b
    with a:
        with b:
            torch.ones(4).sum()
    with _profile() as prof:
        pass
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith(perf.SPAN_PREFIX)]


def test_spans_nest_and_close_on_errors():
    with _profile() as prof:
        with torch.profiler.record_function("caller"):
            with perf.span("outer"):
                with perf.span("inner"):
                    torch.ones(4).sum()
                with pytest.raises(ValueError):
                    with perf.span("raises"):
                        raise ValueError("inside a span")
            with perf.span("after"):
                pass
    ranges = _ranges(prof)
    assert [n for _, _, n in ranges] == ["caller", "port/outer", "port/inner", "port/raises",
                                         "port/after"]
    (c0, c1, _), (o0, o1, _), (i0, i1, _), (r0, r1, _), (a0, a1, _) = ranges
    assert c0 <= o0 <= i0 <= i1 <= r0 <= r1 <= o1 <= a0 <= a1 <= c1


def test_spans_are_host_ranges_of_the_function_scope():
    """The ranges carry their name on the host's timeline and are not user
    annotations, which a trace draws again over the device's kernels."""
    with _profile() as prof:
        with perf.span("probe"):
            torch.ones(4).sum()
    probe = [e for e in prof.profiler.kineto_results.events() if e.name() == "port/probe"]
    assert len(probe) == 1
    assert probe[0].device_type() == torch.autograd.DeviceType.CPU
    assert not probe[0].is_user_annotation()


def test_collate_emits_one_collate_range(qwen):
    model, pack, samples = qwen
    with _profile() as prof:
        with torch.profiler.record_function("caller"):
            collate_icl_batch(samples, model.tokenizer, pack)
    _in_order_within_caller(_ranges(prof), ["collate"])


@pytest.mark.parametrize("num_beams", [1, 2])
def test_engine_batch_emits_copy_encode_prefill_decode_ranges_in_order(qwen, num_beams):
    model, pack, samples = qwen
    packed = collate_icl_batch(samples, model.tokenizer, pack)
    engine = model.engine
    saved = engine.gen
    engine.gen = tengine.GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-1,
                                          pad_token_id=0, num_beams=num_beams)
    try:
        with _profile() as prof:
            with torch.profiler.record_function("caller"):
                toks = engine.generate_tokens(packed, packed.audio)
    finally:
        engine.gen = saved
    assert toks.shape == (2, MAX_NEW)
    _in_order_within_caller(_ranges(prof), ["h2d", "encode", "prefill", "decode", "d2h"])


def test_engine_timings_keep_their_layout_and_encode_has_its_own_list(qwen, monkeypatch):
    """``timings`` holds [prefill ms, step 1 ms, …] a batch, as before; the
    encode's ms goes to ``encode_timings``."""
    model, pack, samples = qwen
    monkeypatch.setattr(tengine, "device_events", lambda device: _HostEvents())
    engine = model.engine
    engine.timings.clear()
    engine.encode_timings.clear()
    packed = collate_icl_batch(samples, model.tokenizer, pack)
    for _ in range(2):
        engine.generate_tokens(packed, packed.audio)
    assert len(engine.timings) == 2 and len(engine.encode_timings) == 2
    for row, enc in zip(engine.timings, engine.encode_timings):
        assert len(row) == MAX_NEW  # the prefill and MAX_NEW - 1 decode steps
        assert all(ms >= 0 for ms in row) and enc > 0
    engine.timings.clear()
    engine.encode_timings.clear()


def _train_step(qwen):
    model, pack, samples = qwen
    opt = tstep.AdamW(tstep.OptimizerSettings(learning_rate=1e-3))
    state, frozen = tstep.init_train_state(model.params, opt, trainable_keys=("lora",))
    step = tstep.make_train_step(model.cfg, opt, loss_fn=tqa.qwen_audio_train_loss)
    b = collate_icl_batch(samples[:1], get_tokenizer(), pack)
    batch = {k: torch.as_tensor(v) for k, v in tloop.batch_arrays(b).items()}
    return step, state, frozen, batch


def test_train_step_emits_forward_backward_update_ranges_in_order(qwen):
    step, state, frozen, batch = _train_step(qwen)
    with _profile() as prof:
        with torch.profiler.record_function("caller"):
            _, metrics = step(state, frozen, batch)
    assert np.isfinite(metrics["loss"]) and metrics["skipped_nonfinite"] == 0.0
    _in_order_within_caller(_ranges(prof), ["step.forward", "step.backward", "step.update"])


def test_train_step_timings_give_three_phases_a_step_and_feed_the_step_timer(qwen,
                                                                            monkeypatch):
    """``step_seconds`` stays on the host's clock; the phases' device sums
    are ``device_step_seconds``, of the steps the timer saw."""
    monkeypatch.setattr(tstep, "device_events", lambda device: _HostEvents())
    step, state, frozen, batch = _train_step(qwen)
    assert step.timings() == []
    step(state, frozen, batch)  # a step before the timer is not its own
    timer = tloop.StepTimer(step)
    for _ in range(2):
        timer.start()
        step(state, frozen, batch)
        timer.stop(1)
    phases = step.timings()
    assert len(phases) == 3 and all(len(p) == 3 and min(p) >= 0 for p in phases)
    summary = timer.summary()
    assert summary["device_step_seconds"] == [sum(p) / 1e3 for p in phases[1:]]
    assert len(summary["step_seconds"]) == 2 and summary["steps"] == 2
    assert summary["examples"] == 2 and len(summary["launches_per_step"]) == 2
    assert summary["total_seconds"] == sum(summary["step_seconds"])


def test_step_timer_uses_the_host_clock_and_never_synchronises(monkeypatch):
    def fail():
        raise AssertionError("the step timer synchronised the device")

    monkeypatch.setattr(torch.cuda, "synchronize", fail)

    def step_fn(state, frozen, batch):
        return state, {}

    step_fn.timings = lambda: []
    for fn in (step_fn, lambda *a: None):
        timer = tloop.StepTimer(fn)
        for _ in range(3):
            timer.start()
            timer.stop(1)
        summary = timer.summary()
        assert len(summary["step_seconds"]) == 3 and summary["steps"] == 3
        assert summary["examples_per_sec"] > 0 and "device_step_seconds" not in summary


def test_train_step_timings_wait_for_the_last_event_only(qwen, monkeypatch):
    """``timings()`` waits for the last step's last mark, which the device
    passes after every earlier one, and no other."""
    made = []

    def device_events(device):
        made.append(_HostEvents())
        return made[-1]

    monkeypatch.setattr(tstep, "device_events", device_events)
    step, state, frozen, batch = _train_step(qwen)
    for _ in range(2):
        step(state, frozen, batch)
    rows = step.timings()
    assert len(rows) == 2 and all(len(r) == 3 for r in rows)
    waited = [ev.waited for events in made for ev in events.events]
    assert waited == [False] * 7 + [True]
