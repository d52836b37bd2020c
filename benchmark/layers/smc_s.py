"""Seconds of the SMC layer a fit (``inference/hyperparam.py:mult_t_posterior`` over
``inference/smc.py``: the tempering ladder, each stage an ESS bisection, systematic
resampling and five random-walk mutations, every likelihood evaluation one batched
Newton solve over the particles × classes): the synced span around it, the mean over
the traced window's fits."""


def read(run):
    return run.span_mean("smc")
