"""Seconds of the regression's training a fit (``models/gpr.py`` under
``inference/optimize.py:minimize_t_noise``: the coarse (t, noise) grid and the Adam
steps, every bandwidth a lane): the synced span around ``fit.drivers._train_gpr``,
the mean over the traced window's fits."""


def read(run):
    return run.span_mean("gpr_train")
