"""The port's continuous-batching engine against the JAX package's, one
counterpart for each test of ``tests/test_serving.py``.

The same requests (numpy embeddings from a seed) go through the JAX
package's ``ContinuousBatchingEngine`` and the port's, on the tiny decoder
in f32 on the CPU, the port's weights bridged from JAX's: every request's
tokens must be identical, and so must the engines' counts of decode
blocks, waves and flushes. The JAX prefill of the int8 pool runs as on its
own target, through the Pallas flash kernel in interpret mode (its engine's
flash gate opened for 128-multiple buckets, as the port's admission always
takes K1). Sampling cannot match JAX's PRNG and is tested by its
properties.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from icl_speech_text_llm_tpu.inference import serving as jserving
from icl_speech_text_llm_tpu.models import llama as jllama
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.inference import engine as tengine
from icl_speech_text_llm_tpu_torch.inference import serving as tserving
from icl_speech_text_llm_tpu_torch.models import llama as tllama

torch.set_num_threads(1)
MAX_NEW = 6
EOS = 2
#: the JAX engines' results, each scenario run once per module
_JAX = {}


@pytest.fixture
def jax_serving_flash(monkeypatch):
    """JAX serving's admission as the port runs it: Pallas in interpret mode
    and the engine's flash gate open for 128-multiple buckets."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jserving, "_flash_prefill_ok", lambda use_flash, L, cfg: L % 128 == 0)


@pytest.fixture(scope="module")
def llm():
    cfg = jllama.DECODER_CONFIGS["tiny"]
    jparams = jllama.init_decoder(jax.random.PRNGKey(0), cfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return {"jax": (jserving, cfg, jparams), "torch": (tserving, tllama.DECODER_CONFIGS["tiny"],
                                                       tparams)}


def _requests(dim, n, seed=0):
    rng = np.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        length = int(rng.randint(5, 24))
        reqs.append(((rng.randn(length, dim) * 0.3).astype(np.float32), length))
    return reqs


def _engine(world, scfg_kw, **kw):
    mod, cfg, params = world
    if mod is tserving:
        kw["device"] = "cpu"
    return mod.ContinuousBatchingEngine(cfg, params, mod.ServingConfig(**scfg_kw), **kw)


def _stats(eng):
    s = eng.stats
    return (s["decode_blocks"], dict(s["prefill_waves"]), s["flushes"], s.get("beam_waves", 0),
            s.get("chunk_dispatches", 0))


def _both(llm, name, scenario):
    """scenario(world) → result, for the port and (once a module) for JAX."""
    if name not in _JAX:
        _JAX[name] = scenario(llm["jax"])
    return scenario(llm["torch"]), _JAX[name]


def _all_at_once(scfg_kw, reqs, **submit_kw):
    def scenario(world):
        eng = _engine(world, scfg_kw)
        rids = [eng.submit(emb, length, **submit_kw) for emb, length in reqs]
        res = eng.run()
        return [res[r] for r in rids], _stats(eng)
    return scenario


def _static_greedy(llm, emb, length):
    """The port's static engine on one request (batch 1, bucket 32)."""
    _, cfg, params = llm["torch"]
    padded = np.zeros((1, 32, cfg.dim), np.float32)
    padded[0, :length] = emb
    gen = tengine.GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=EOS, pad_token_id=0)
    toks = tengine.decode_from_sequence(cfg, params, torch.from_numpy(padded),
                                        torch.tensor([length]), gen)[0].tolist()
    return toks[:toks.index(EOS)] if EOS in toks else toks


def test_matches_oracle_all_at_once(llm):
    reqs = _requests(128, 7)
    scfg = dict(num_slots=3, max_new_tokens=MAX_NEW, prompt_buckets=(16, 32), eos_token_id=EOS)
    (got, stats), (want, jstats) = _both(llm, "all_at_once", _all_at_once(scfg, reqs))
    assert got == want
    assert stats == jstats
    assert stats[0] > 0 and sum(stats[1].values()) >= 3 and stats[2] >= 1
    # and the port's own static engine, request by request
    assert got == [_static_greedy(llm, emb, length) for emb, length in reqs]


def test_staggered_arrivals_and_slot_reuse(llm):
    reqs = _requests(128, 6, seed=1)
    scfg = dict(num_slots=2, max_new_tokens=MAX_NEW, prompt_buckets=(16, 32), eos_token_id=EOS)

    def scenario(world):
        eng = _engine(world, scfg)
        rids = [eng.submit(*reqs[i]) for i in range(3)]
        for _ in range(3):
            eng.step()
        rids += [eng.submit(*reqs[i]) for i in range(3, 6)]
        res = eng.run()
        return [res[r] for r in rids], _stats(eng)

    got, want = _both(llm, "staggered", scenario)
    assert got == want


def _eos_scfg(llm, **kw):
    """An EOS the model emits at step 2 of request seed 2's free run."""
    free_run = _both(llm, "free_run", _all_at_once(
        dict(num_slots=2, max_new_tokens=MAX_NEW, prompt_buckets=(16, 32), eos_token_id=EOS),
        _requests(128, 1, seed=2)))[1][0][0]
    assert len(free_run) >= 2, "needs a multi-token continuation"
    return free_run, dict(eos_token_id=free_run[1], **kw)


def test_eos_truncation(llm):
    free_run, scfg = _eos_scfg(llm, num_slots=2, max_new_tokens=MAX_NEW, prompt_buckets=(16, 32))
    (got, _), (want, _) = _both(llm, "eos", _all_at_once(scfg, _requests(128, 1, seed=2)))
    assert got == want == [free_run[:1]]


def test_oversize_prompt_rejected(llm):
    for world in (llm["torch"], llm["jax"]):
        eng = _engine(world, dict(num_slots=1, prompt_buckets=(16,)))
        with pytest.raises(ValueError, match="exceeds largest bucket"):
            eng.submit(np.zeros((40, 128), np.float32), 40)


def test_per_request_sampling_isolation(llm):
    """Greedy rows are unchanged by a sampled neighbour, at any seed; the
    same seed gives the same samples, another seed others; every sampled
    token lies in the vocabulary."""
    reqs = _requests(128, 2, seed=3)
    scfg = dict(num_slots=2, max_new_tokens=MAX_NEW, prompt_buckets=(16, 32), eos_token_id=EOS)

    def run_pair(world, seed):
        eng = _engine(world, scfg, seed=seed)
        r_greedy = eng.submit(*reqs[0])
        r_hot = eng.submit(*reqs[1], temperature=5.0)
        out = eng.run()
        return out[r_greedy], out[r_hot]

    (greedy_a, hot_a), (greedy_want, _) = _both(llm, "sampling", lambda w: run_pair(w, 0))
    greedy_b, hot_b = run_pair(llm["torch"], 0)
    greedy_c, hot_c = run_pair(llm["torch"], 7)
    assert greedy_a == greedy_b == greedy_c == greedy_want
    assert hot_a == hot_b
    assert hot_a != hot_c
    vocab = llm["torch"][1].vocab_size
    assert all(0 <= t < vocab for t in hot_a + hot_c)


def test_cap_flush_reclaims_early_eos_lanes(llm):
    _, scfg = _eos_scfg(llm, num_slots=1, max_new_tokens=64, prompt_buckets=(16, 32),
                        sync_every=4, max_pending_blocks=2)
    emb, length = _requests(128, 1, seed=2)[0]

    def scenario(world):
        eng = _engine(world, scfg)
        rids = [eng.submit(emb, length), eng.submit(emb, length)]
        steps = 0
        while len(eng._results) < 2 and steps < 200:
            eng.step()
            steps += 1
        eng._flush()
        return [eng._results[r] for r in rids], steps

    (got, steps), (want, jsteps) = _both(llm, "cap_flush", scenario)
    assert got == want and steps == jsteps
    assert steps <= 12, steps


def test_per_request_max_new_tokens(llm):
    reqs = _requests(128, 6, seed=3)
    budgets = [1, MAX_NEW, 2, 3, MAX_NEW, 2]
    scfg = dict(num_slots=2, max_new_tokens=MAX_NEW, prompt_buckets=(16, 32), eos_token_id=EOS)

    def scenario(world):
        eng = _engine(world, scfg)
        rids = [eng.submit(emb, length, max_new_tokens=b) for (emb, length), b in zip(reqs, budgets)]
        res = eng.run()
        return [res[r] for r in rids], _stats(eng)

    got, want = _both(llm, "budgets", scenario)
    assert got == want
    assert [len(t) <= b for t, b in zip(got[0], budgets)] == [True] * 6


def test_per_request_budget_validation(llm):
    emb, length = _requests(128, 1)[0]
    for world in (llm["torch"], llm["jax"]):
        eng = _engine(world, dict(num_slots=2, max_new_tokens=MAX_NEW, prompt_buckets=(16, 32)))
        for bad in (MAX_NEW + 1, 0):
            with pytest.raises(ValueError):
                eng.submit(emb, length, max_new_tokens=bad)


def test_kv_int8_serving_matches_kv_int8_oracle(llm, jax_serving_flash):
    """The int8 pool: admission through the flash prefill (unquantized
    current k/v) in both, each decode step's append quantized."""
    reqs = _requests(128, 5, seed=3)
    scfg = dict(num_slots=3, max_new_tokens=MAX_NEW, prompt_buckets=(128,), eos_token_id=EOS,
                kv_int8=True)
    (got, stats), (want, jstats) = _both(llm, "kv_int8", _all_at_once(scfg, reqs))
    assert got == want
    assert stats == jstats
    # the port's static engine with an int8 cache gives the same tokens
    _, cfg, params = llm["torch"]
    gen = tengine.GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=EOS, pad_token_id=0,
                                   kv_int8=True)
    for toks, (emb, length) in zip(got, reqs):
        padded = np.zeros((1, 128, cfg.dim), np.float32)
        padded[0, :length] = emb
        ref = tengine.decode_from_sequence(cfg, params, torch.from_numpy(padded),
                                           torch.tensor([length]), gen)[0].tolist()
        assert toks == (ref[:ref.index(EOS)] if EOS in ref else ref)


def test_per_request_num_beams(llm):
    reqs = _requests(128, 5, seed=3)
    scfg = dict(num_slots=2, max_new_tokens=MAX_NEW, prompt_buckets=(32,), eos_token_id=EOS,
                admit_batch=2)

    def scenario(world):
        eng = _engine(world, scfg)
        rids = [eng.submit(emb, length, num_beams=3 if i % 2 == 0 else 1)
                for i, (emb, length) in enumerate(reqs)]
        res = eng.run()
        return [res[r] for r in rids], _stats(eng)

    (got, stats), (want, jstats) = _both(llm, "num_beams", scenario)
    assert got == want
    assert stats == jstats and stats[3] >= 1


def test_beam_lane_budget_and_width_grouping(llm):
    reqs = _requests(128, 4, seed=11)
    plan = [(2, None), (4, None), (2, 2), (4, None)]  # (num_beams, max_new_tokens)
    scfg = dict(num_slots=2, max_new_tokens=MAX_NEW, prompt_buckets=(32,), eos_token_id=EOS,
                admit_batch=2)

    def scenario(world):
        eng = _engine(world, scfg)
        rids = [eng.submit(emb, length, num_beams=k, max_new_tokens=m)
                for (emb, length), (k, m) in zip(reqs, plan)]
        res = eng.run()
        return [res[r] for r in rids], _stats(eng)

    (got, stats), (want, jstats) = _both(llm, "beam_grouping", scenario)
    assert got == want and stats == jstats
    assert len(got[2]) <= 2


def test_num_beams_validation(llm):
    for world in (llm["torch"], llm["jax"]):
        eng = _engine(world, dict(prompt_buckets=(32,)))
        with pytest.raises(ValueError):
            eng.submit(np.zeros((4, 128), np.float32), 4, num_beams=0)


def test_multi_lora_bank_serving(llm):
    """One pool serving two adapters of a bank, beam requests too (their
    waves group by adapter): the JAX bank bridged leaf for leaf."""
    _, jcfg, _ = llm["jax"]
    lcfg = jllama.LoraConfig(rank=4, targets=("wq", "wv"))
    adapters = [jax.tree_util.tree_map(lambda x, _s=s: x + 0.05 * (_s + 1),
                                       jllama.init_lora(jax.random.PRNGKey(s), jcfg, lcfg))
                for s in (7, 8)]
    jbank = jllama.stack_lora_bank(adapters)
    tbank = params_from_numpy(jax.tree_util.tree_map(np.asarray, jbank), device="cpu")
    assert tbank["wq"]["a"].shape == (jcfg.n_layers, 2, jcfg.dim, 4)
    reqs = _requests(128, 5, seed=21)
    plan = [(0, 1), (1, 1), (0, 1), (1, 2), (0, 2)]  # (adapter_id, num_beams)
    scfg = dict(num_slots=2, max_new_tokens=MAX_NEW, prompt_buckets=(32,), eos_token_id=EOS,
                admit_batch=2)

    def scenario(world):
        bank = tbank if world[0] is tserving else jbank
        eng = _engine(world, scfg, lora=bank, lora_scaling=lcfg.scaling)
        rids = [eng.submit(emb, length, adapter_id=aid, num_beams=k)
                for (emb, length), (aid, k) in zip(reqs, plan)]
        res = eng.run()
        return [res[r] for r in rids], _stats(eng)

    got, want = _both(llm, "lora_bank", scenario)
    assert got == want
    # each adapter matters: the same requests under adapter 0 alone differ
    single = [(0, k) for _, k in plan]
    eng = _engine(llm["torch"], scfg, lora=tbank, lora_scaling=lcfg.scaling)
    rids = [eng.submit(emb, length, adapter_id=aid, num_beams=k)
            for (emb, length), (aid, k) in zip(reqs, single)]
    res = eng.run()
    assert [res[r] for r in rids] != got[0]


def test_adapter_id_requires_bank(llm):
    for world in (llm["torch"], llm["jax"]):
        eng = _engine(world, dict(prompt_buckets=(32,)))
        with pytest.raises(ValueError):
            eng.submit(np.zeros((4, 128), np.float32), 4, adapter_id=1)


def test_chunked_prefill_matches_unchunked(llm):
    reqs = _requests(128, 10, seed=33)
    base = dict(num_slots=2, max_new_tokens=MAX_NEW, prompt_buckets=(32,), eos_token_id=EOS,
                admit_batch=2)
    (got, stats), (want, jstats) = _both(llm, "chunked",
                                         _all_at_once(dict(base, chunk_len=8), reqs))
    assert got == want and stats == jstats
    assert stats[4] >= 4 * len(reqs) // 2
    unchunked, _ = _all_at_once(base, reqs)(llm["torch"])
    assert got == unchunked


def test_chunked_prefill_validation(llm):
    for world in (llm["torch"], llm["jax"]):
        with pytest.raises(ValueError):
            _engine(world, dict(prompt_buckets=(48,), chunk_len=32))


def test_completed_streams_results_incrementally(llm):
    reqs = _requests(128, 8, seed=44)
    scfg = dict(num_slots=2, max_new_tokens=MAX_NEW, prompt_buckets=(32,), eos_token_id=EOS,
                admit_batch=2)
    eng = _engine(llm["torch"], scfg)
    rids = [eng.submit(emb, length) for emb, length in reqs]
    seen, polls_with_results = {}, 0
    for _ in range(200):
        eng.step()
        got = eng.completed()
        assert not (set(got) & set(seen))
        polls_with_results += bool(got)
        seen.update(got)
        if len(seen) == len(reqs):
            break
    assert len(seen) == len(reqs)
    assert polls_with_results > 1
    _, (want, _) = _both(llm, "streamed", _all_at_once(scfg, reqs))
    assert [seen[r] for r in rids] == want


def test_steps_read_no_device_value(llm, monkeypatch):
    """The schedule is host-deterministic: admission, chunked admission,
    prefix registration and decode blocks read no value back from the
    device (no ``item``, ``tolist``, ``cpu``, ``numpy`` or ``bool`` of a
    tensor); only the flush does."""
    reqs = _requests(128, 5, seed=8)
    eng = _engine(llm["torch"], dict(num_slots=2, max_new_tokens=MAX_NEW, prompt_buckets=(32,),
                                     prefix_buckets=(32,), eos_token_id=EOS, admit_batch=2,
                                     chunk_len=8, max_pending_blocks=1000))
    prefix = reqs[0][0][:20]
    with monkeypatch.context() as m:
        for name in ("item", "tolist", "cpu", "numpy", "__bool__"):
            m.setattr(torch.Tensor, name, lambda *a, _n=name: pytest.fail(f"read back: {_n}"))
        pid = eng.register_prefix(prefix, 20)
        rids = [eng.submit(emb, length, prefix_id=pid if i % 2 else None)
                for i, (emb, length) in enumerate(reqs)]
        for _ in range(12):
            eng.step()
        assert not eng._live() and not eng._queue and eng.stats["flushes"] == 0
    res = eng.run()
    assert sorted(res) == rids and eng.stats["flushes"] == 1
