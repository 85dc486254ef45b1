"""Relaunch supervisor: a hung-step watchdog exit becomes a resume from the
latest checkpoint. Counterpart of ``acr_wsss_tpu/utils/supervisor.py``.

The train stage runs in a child process. When the child exits
``EX_TEMPFAIL`` (75), the step watchdog's exit (``utils/watchdog.py``),
it is relaunched, and ``train.train`` resumes from the latest
step-numbered checkpoint with the optimizer state and the LR schedule
intact. Any other failure, or a watchdog exit past the budget of
relaunches, raises instead of looping.

The child is started with ``spawn``, not ``fork``: a CUDA context cannot
be forked, and a hung child holds a wedged device context that only a
fresh process leaves behind. The child imports ``acr_wsss_tpu_torch.train``
and nothing else of the caller's state.
"""

from __future__ import annotations

import multiprocessing as mp

from acr_wsss_tpu_torch.utils.watchdog import EX_TEMPFAIL


def _train_child(cfg) -> None:
    from acr_wsss_tpu_torch.train import train

    train(cfg)


def run_train_supervised(cfg, max_relaunches: int = 2) -> int:
    """Run ``train(cfg)`` in a child process under relaunch supervision;
    returns the number of relaunches that were needed."""
    ctx = mp.get_context("spawn")
    relaunches = 0
    while True:
        p = ctx.Process(target=_train_child, args=(cfg,))
        p.start()
        p.join()
        if p.exitcode == 0:
            return relaunches
        if p.exitcode == EX_TEMPFAIL and relaunches < max_relaunches:
            relaunches += 1
            print(f"supervisor: train stage exited {EX_TEMPFAIL} (hung-step watchdog); "
                  f"relaunch {relaunches}/{max_relaunches} will resume from the latest "
                  "checkpoint", flush=True)
            continue
        raise RuntimeError(f"train stage failed with exit code {p.exitcode} after "
                           f"{relaunches} relaunch(es)")
