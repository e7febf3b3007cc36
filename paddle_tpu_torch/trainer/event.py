"""Trainer events (counterpart of ``paddle_tpu/trainer/event.py``; analog
of python/paddle/v2/event.py: BeginPass, EndPass, BeginIteration,
EndIteration, TestResult)."""

from __future__ import annotations


class WithMetric:
    def __init__(self, evaluator_result=None):
        self.metrics = evaluator_result or {}


class BeginPass:
    def __init__(self, pass_id):
        self.pass_id = pass_id


class EndPass(WithMetric):
    def __init__(self, pass_id, evaluator_result=None):
        super().__init__(evaluator_result)
        self.pass_id = pass_id


class BeginIteration:
    def __init__(self, pass_id, batch_id):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration(WithMetric):
    def __init__(self, pass_id, batch_id, cost, evaluator_result=None):
        super().__init__(evaluator_result)
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost


class TestResult(WithMetric):
    def __init__(self, cost, evaluator_result=None):
        super().__init__(evaluator_result)
        self.cost = cost
