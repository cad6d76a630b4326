"""Triggers for ending training (counterpart of
``bigdl_tpu/optim/trigger.py``: ``max_epoch``, ``max_iteration``,
``every_epoch``, ``several_iteration``, ``max_score``, ``min_loss``,
``and_``, ``or_``).  A trigger is a predicate over the driver state dict
(``"epoch"``, ``"neval"``, ``"record_count"``, ``"loss"``,
``"score"``), evaluated on the host between steps."""


class Trigger:
    #: mutates internal state on every call -- must not be probed with a
    #: PREDICTED driver state (the training loop's batch-staging guard)
    stateful: bool = False
    #: reads step outputs (loss/score) the prediction cannot know yet;
    #: the loop then syncs every step (``set_sync_every`` falls back to 1)
    uses_outputs: bool = False

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

    @staticmethod
    def max_score(max_score):
        return _Lambda(lambda s: s.get("score", float("-inf")) > max_score,
                       uses_outputs=True)

    @staticmethod
    def min_loss(min_loss):
        return _Lambda(lambda s: s.get("loss", float("inf")) < min_loss,
                       uses_outputs=True)

    @staticmethod
    def and_(first, *others):
        return _combine(lambda s, ts: all(t(s) for t in ts), first, *others)

    @staticmethod
    def or_(first, *others):
        return _combine(lambda s, ts: any(t(s) for t in ts), first, *others)


def _combine(how, *triggers):
    t = _Lambda(lambda s: how(s, triggers))
    t.stateful = any(getattr(x, "stateful", False) for x in triggers)
    t.uses_outputs = any(getattr(x, "uses_outputs", False) for x in triggers)
    return t


class _Lambda(Trigger):
    def __init__(self, fn, uses_outputs=False):
        self.fn = fn
        self.uses_outputs = uses_outputs

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
