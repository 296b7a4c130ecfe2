"""Mean host ms a step of the window waits in ``next()`` on the task's
loader (the benchmark's span around the call)."""


def read(run):
    waits = (run.get("spans") or {}).get("loader_wait") or []
    return 1e3 * sum(waits) / len(waits) if waits else None
