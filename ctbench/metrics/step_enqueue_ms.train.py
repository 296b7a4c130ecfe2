"""Mean host ms of the window for ``Trainer.train_step`` to return, with no
synchronize: the host's launch path of a step."""


def read(run):
    spans = (run.get("spans") or {}).get("step_enqueue") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
