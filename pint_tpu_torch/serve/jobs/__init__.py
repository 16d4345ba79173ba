"""Background compute class: preemptible sampling and grid jobs on spare
serving capacity.

Counterpart of ``pint_tpu/serve/jobs/``.  A second traffic class next to
interactive serving: long-running jobs (``grid_chisq`` chi2 surfaces,
``mcmc`` ensemble sampling, ``nested`` evidence runs) enter through the
same ``TimingEngine.submit`` surface as a
:class:`~pint_tpu_torch.serve.api.JobRequest`, are cut into bounded
device-time *quanta* by the :class:`~pint_tpu_torch.serve.jobs.scheduler.
JobScheduler`, and run only on replicas the router reports idle.  Under
SLO pressure the scheduler yields — the quantum in flight finishes, the
job checkpoints (``pint_tpu_torch.checkpoint.save_job``), and it resumes
bitwise where it left off when the pressure clears, across process
restarts too (the warm ledger replays job programs).
"""

from pint_tpu_torch.serve.jobs.api import (  # noqa: F401
    PREEMPTED,
    QUEUED,
    RUNNING,
    Job,
)
from pint_tpu_torch.serve.jobs.scheduler import JobScheduler  # noqa: F401
