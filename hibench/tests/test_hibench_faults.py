"""The check that decides ``correct`` has to fail a broken program: the
harness's whole run (its look for a card skipped) at toy size on the CPU,
with the timed path broken underneath, once for each fault a serving cell
on one card can have: a decode step that leaves its state unchanged, half
of the batch left out of a step, a token altered where it is produced, and
the gate's answer altered where it is produced, wholly or by 3%.  (One
card: no exchange between chips to leave out.)"""
import pytest
import torch

from hibench import run
from hibench.tests import tiny


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state_unchanged(monkeypatch):
    from repro_torch.models import model_zoo
    orig = model_zoo.decode_step_paged

    def step(params, cfg, token, pos, block, cache, **kw):
        scratch = {k: v.clone() if torch.is_tensor(v) else v
                   for k, v in cache.items()}
        logits, _ = orig(params, cfg, token, pos, block, scratch, **kw)
        return logits, cache
    monkeypatch.setattr(model_zoo, "decode_step_paged", step)


def _half_batch(monkeypatch):
    from repro_torch.models import model_zoo
    orig = model_zoo.decode_step_paged

    def step(params, cfg, token, pos, block, cache, **kw):
        logits, cache = orig(params, cfg, token, pos, block, cache, **kw)
        half = logits.shape[0] // 2
        logits[half:] = logits[:half].mean(0)
        return logits, cache
    monkeypatch.setattr(model_zoo, "decode_step_paged", step)


def _token_altered(monkeypatch):
    from repro_torch.serving import sampler
    orig = sampler.greedy

    def greedy(logits):
        tok = orig(logits)
        return (tok + (tok.shape[0] > 2)) % logits.shape[-1]
    monkeypatch.setattr(sampler, "greedy", greedy)


def _gate_altered(monkeypatch):
    from repro_torch.kernels import ops
    orig = ops.hi_gate

    def gate(logits, theta, metric="max_prob"):
        conf, *rest = orig(logits, theta, metric)
        return (1.0 - conf, *rest)
    monkeypatch.setattr(ops, "hi_gate", gate)


def _gate_scaled(monkeypatch):
    """The gate's confidence 3% high: decisions flip only near theta."""
    from repro_torch.kernels import ops
    orig = ops.hi_gate

    def gate(logits, theta, metric="max_prob"):
        conf, *rest = orig(logits, theta, metric)
        return (conf * 1.03, *rest)
    monkeypatch.setattr(ops, "hi_gate", gate)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered, "gate_altered": _gate_altered,
          "gate_scaled": _gate_scaled}


@pytest.mark.parametrize("name", ["h2o-danube-3-4b", "deepseek-moe-16b"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_program_is_not_correct(monkeypatch, name, fault):
    cell = tiny.cell(name)
    FAULTS[fault](monkeypatch)
    res = run.execute(cell, 3 * 2 ** 31 + 1, 0.0, False, "cpu")
    assert not res["correct"], tiny.dump(res)
