"""Triggers for ending training (counterpart of
``bigdl_tpu/optim/trigger.py``: ``max_epoch``, ``max_iteration``,
``every_epoch``, ``several_iteration``).  A trigger is a predicate over
the driver state dict (``"epoch"``, ``"neval"``, ``"record_count"``,
``"loss"``), evaluated on the host between steps."""


class Trigger:
    #: mutates internal state on every call -- must not be probed with a
    #: PREDICTED driver state (the training loop's batch-staging guard)
    stateful: bool = False

    def __call__(self, state) -> bool:
        raise NotImplementedError

    @staticmethod
    def max_epoch(n):
        return _Lambda(lambda s: s.get("epoch", 1) > n)

    @staticmethod
    def max_iteration(n):
        return _Lambda(lambda s: s.get("neval", 1) > n)

    @staticmethod
    def every_epoch():
        return _EveryEpoch()

    @staticmethod
    def several_iteration(interval):
        return _Lambda(lambda s: s.get("neval", 1) % interval == 0)


class _Lambda(Trigger):
    def __init__(self, fn):
        self.fn = fn

    def __call__(self, state):
        return bool(self.fn(state))


class _EveryEpoch(Trigger):
    """Fires when the epoch counter advances past the last fire."""

    stateful = True

    def __init__(self):
        self.last_epoch = None

    def __call__(self, state):
        epoch = state.get("epoch", 1)
        if self.last_epoch is None:
            self.last_epoch = epoch
            return False
        if epoch > self.last_epoch:
            self.last_epoch = epoch
            return True
        return False
