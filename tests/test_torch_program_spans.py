"""The port's spans where the work happens (``telemetry.stage`` records).

  * ``Scorer.score_async`` records one ``scorer.dispatch`` with a
    ``scorer.upload`` and a ``scorer.launch`` child, all under the batch's
    number; ``finalize_many`` records no ``scorer.card_wait`` on the CPU;
  * ``Trainer.train_batch`` records one ``trainer.step`` with one
    ``trainer.forward``, ``trainer.backward`` and ``trainer.update`` child,
    all under the step's number, with or without ``sync``;
  * on the card (marked ``card``; skips without one) ``finalize_many`` and
    ``Trainer.read_metrics`` record the card's wait for the host from timed
    CUDA events, once per batch or step after the first.

Imports no JAX: on the card, run it alone with ``python -m pytest
--noconftest tests/test_torch_program_spans.py``.
"""

import threading
import time

import numpy as np
import pytest
import torch

from hello_tpu_torch import telemetry
from hello_tpu_torch.nn import layers
from hello_tpu_torch.nn.convert import init_params
from hello_tpu_torch.nn.moe import create_model
from hello_tpu_torch.pipeline.batching import SiteWork, pack_sites
from hello_tpu_torch.pipeline.call import Scorer
from hello_tpu_torch.train.trainer import Trainer, TrainConfig

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def highest():
    layers.set_precision("highest")
    yield
    layers.set_precision("highest")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's events")
    return torch.device("cuda", 0)


def _sites(seed=0, n=3):
    rng = np.random.RandomState(seed)

    def reads(k):
        return [rng.randint(0, 255, (k, 150, 6)).astype(np.uint8)
                for _ in range(2)]
    return [SiteWork("c", 10 * i, 10 * i + 1, ["A", "C"], reads(3 + i), None,
                     np.eye(5, dtype=np.float32)[rng.randint(0, 5, 150)])
            for i in range(n)]


def _model():
    model = create_model("illumina")
    init_params(model, torch.Generator().manual_seed(3))
    return model


def _train_batch(seed=0, A=4, R=3, S=2):
    rng = np.random.RandomState(seed)
    mask = (rng.rand(A, R) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    batch = {
        "reads0": rng.randint(0, 255, (A, R, 150, 6)).astype(np.uint8),
        "read_mask0": mask,
        "site_ids": np.minimum(np.arange(A, dtype=np.int32) // 2, S - 1),
        "allele_mask": np.ones((A,), np.float32),
        "ref_segments": np.eye(5, dtype=np.float32)[rng.randint(0, 5, (S, 150))],
        "labels": (rng.rand(A) < 0.5).astype(np.float32),
    }
    return {k: v[None] for k, v in batch.items()}


def _window(since):
    return [s for s in telemetry.spans(since, telemetry.now_ns())
            if s.thread == threading.get_native_id()]


def test_scorer_records_dispatch_with_upload_and_launch():
    scorer = Scorer(_model(), device="cpu")
    batch = pack_sites(_sites(), hybrid=False)
    since = telemetry.now_ns()
    first = scorer.score_async(batch, decode=True)
    second = scorer.score_async(batch, decode=True)
    scorer.finalize_many([first, second])
    got = _window(since)
    for key in (0, 1):
        mine = sorted((s for s in got if s.key == key),
                      key=lambda s: s.start_ns)
        assert [s.name for s in mine] == ["scorer.dispatch", "scorer.upload",
                                          "scorer.launch"]
        dispatch = mine[0]
        assert [s.parent for s in mine[1:]] == ["scorer.dispatch"] * 2
        for s in mine[1:]:
            assert dispatch.start_ns <= s.start_ns <= s.end_ns \
                <= dispatch.end_ns
    assert not [s for s in got if s.name == "scorer.card_wait"]
    until = telemetry.now_ns()
    own = telemetry.mean_ms("scorer.dispatch", since, until, exclusive=True)
    assert 0 <= own < telemetry.mean_ms("scorer.dispatch", since, until)


@pytest.mark.parametrize("sync", [True, False])
def test_trainer_records_step_with_forward_backward_update(sync):
    trainer = Trainer(_model(), TrainConfig(binary=True), device="cpu",
                      seed=4)
    since = telemetry.now_ns()
    m = trainer.train_batch(_train_batch(), sync=sync)
    loss = m["loss"] if sync else Trainer.read_metrics(m)[0]
    assert np.isfinite(loss)
    got = sorted(_window(since), key=lambda s: s.start_ns)
    assert [s.name for s in got] == ["trainer.step", "trainer.forward",
                                     "trainer.backward", "trainer.update"]
    assert {s.key for s in got} == {0}
    step = got[0]
    assert step.parent is None
    for s in got[1:]:
        assert s.parent == "trainer.step"
        assert step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns
    assert trainer.step == 1


@pytest.mark.card
def test_card_wait_is_recorded_from_the_cards_events(card):
    layers.set_precision("bf16")
    scorer = Scorer(_model(), device=card)
    batch = pack_sites(_sites(n=4), hybrid=False)
    since = telemetry.now_ns()
    scorer.finalize(scorer.score_async(batch, decode=True))     # key 0
    time.sleep(0.03)                 # the card idles while the host sleeps
    scorer.finalize(scorer.score_async(batch, decode=True))     # key 1
    torch.cuda._sleep(200_000_000)   # about 0.1 s of work ahead of keys 2, 3
    scorer.finalize_many([scorer.score_async(batch, decode=True)
                          for _ in range(2)])
    got = _window(since)
    dispatch = {s.key: s for s in got if s.name == "scorer.dispatch"}
    waits = {s.key: s for s in got if s.name == "scorer.card_wait"}
    # key 0 follows no end event; 3's first event follows 2's end at once
    assert sorted(waits) == [1, 2, 3]
    for key, w in waits.items():
        assert w.start_ns == dispatch[key].start_ns
    assert waits[1].end_ns - waits[1].start_ns >= 25e6
    assert waits[3].end_ns - waits[3].start_ns < 1e6

    layers.set_precision("highest")
    trainer = Trainer(_model(), TrainConfig(binary=True), device=card, seed=4)
    staged = trainer.stage_batches(_train_batch())
    since = telemetry.now_ns()
    steps = [trainer.train_batch(staged, sync=False) for _ in range(3)]
    for m in steps:
        assert np.isfinite(Trainer.read_metrics(m)[0])
    Trainer.read_metrics(steps[-1])        # a second read records nothing
    got = _window(since)
    step = {s.key: s for s in got if s.name == "trainer.step"}
    waits = [s for s in got if s.name == "trainer.card_wait"]
    assert [w.key for w in waits] == [1, 2]
    for w in waits:
        assert w.start_ns == step[w.key].start_ns and w.end_ns >= w.start_ns
