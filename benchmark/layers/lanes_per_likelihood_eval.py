"""Newton lanes a likelihood evaluation solves together (``inference/hyperparam.py``:
each evaluation over all particles is one batched Newton solve of ``models/gpc.py``
over particles × classes): the program's ``smc_lanes`` counter over its
``smc_likelihood_evals`` (one an evaluation), over the traced window's fits.  A
program that counts no evaluation has nothing to read."""

from lib.counters import per_fit


def read(run):
    evals = per_fit("smc_likelihood_evals", run)
    if not evals:
        return None
    return per_fit("smc_lanes", run) / evals
