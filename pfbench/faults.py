"""Faults planted underneath a cell's timed path, for the tests that see
`correct` come out false and for the readings of a fault on the card
(`python3 -m pfbench.control --fault NAME`). Each is a context manager
that breaks the program, never the reference.

    altered_answer   one event's served draws a request moved (their
                     distances doubled): an answer altered where it is
                     produced
    state_unchanged  the optimizer's update does nothing (its count moves)
    half_batch       the loss is the mean over half of the batch
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def altered_answer():
    from posteriflow_torch.inference.pipeline import InferenceEngine
    from posteriflow_torch.models.long_bns import LongBNSNPEv4
    serve, raw = InferenceEngine.sample_posterior, LongBNSNPEv4.sample_raw

    def served(self, *args, **kw):
        theta, log_q, railed = serve(self, *args, **kw)
        theta = theta.clone()
        theta[0, :, 2] *= 2.0
        return theta, log_q, railed

    def served_raw(self, *args, **kw):
        theta, y = raw(self, *args, **kw)
        theta = theta.clone()
        theta[0, :, 2] *= 2.0
        return theta, y
    InferenceEngine.sample_posterior = served
    LongBNSNPEv4.sample_raw = served_raw
    try:
        yield
    finally:
        InferenceEngine.sample_posterior = serve
        LongBNSNPEv4.sample_raw = raw


@contextlib.contextmanager
def state_unchanged():
    from posteriflow_torch.train import trainer
    step = trainer.Optimizer.step

    def no_update(self):
        self.count += 1
    trainer.Optimizer.step = no_update
    try:
        yield
    finally:
        trainer.Optimizer.step = step


@contextlib.contextmanager
def half_batch():
    from posteriflow_torch.train import trainer
    full = trainer.batch_nll

    def half(model, batch, group=None):
        n = batch.strain.shape[0] // 2
        return full(model, type(batch)(*(t[:n] for t in batch)), group)
    trainer.batch_nll = half
    try:
        yield
    finally:
        trainer.batch_nll = full


FAULTS = {"altered_answer": altered_answer,
          "state_unchanged": state_unchanged,
          "half_batch": half_batch}
