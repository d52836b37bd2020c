"""The recorder of flgp_tpu_torch (``utils/metrics.py``): spans, counters and
``to_host`` on the two LAE drivers, float64 on the CPU.

A fit with the recorder on gives the same bits as one with it off; the spans
form one tree under ``fit`` with each layer once, every child inside its
parent; ``host_syncs`` counts every blocking read the fit makes (each read
that a patch of the tensor's read methods sees); ``lloyd_rounds`` and
``newton_rounds`` count the rounds run, and ``lloyd_kernel_rounds`` the Lloyd
passes sent to K1, none on the CPU; under the profiler every span is a
``flgp:`` range of the trace.  The SE regression with its bandwidth grid
opens a ``grid`` span for each bandwidth and counts ``grid_spectra`` there,
and ``adam_steps`` in its ``train`` span.  The out-of-core binary fit, from
an FLGP0001 file, opens ``reservoir``, ``subsample``, ``graph``,
``spectrum``, ``train`` and ``predict`` under ``fit`` and counts each chunk
its three passes hand on (``stream_chunks``).
"""

import json
import math
from collections import Counter

import numpy as np
import pytest
import torch

import flgp_tpu_torch as ft
from flgp_tpu_torch import native
from flgp_tpu_torch.datasets import mnist_like, spiral, torus_rings
from flgp_tpu_torch.fit import streaming
from flgp_tpu_torch.inference import nuts
from flgp_tpu_torch.models import gpc
from flgp_tpu_torch.ops import hopper_kernels as hk
from flgp_tpu_torch.ops import kmeans
from flgp_tpu_torch.utils import metrics
from flgp_tpu_torch.utils.metrics import MetricsReport, count, recording, span, to_host

torch.set_num_threads(1)

F64 = torch.float64
CFG = ft.FitConfig(graph=ft.GraphConfig(s=48, r=3, K=16), dtype=F64, n_gibbs=12,
                   gibbs_avg_sweeps=6, train=ft.TrainConfig(grid_size=8))
# each layer's span and its parent, as the two LAE drivers open them
TREE = {"fit": None, "upload": "fit", "subsample": "fit", "graph": "fit", "knn": "graph",
        "lae_weights": "graph", "spectrum": "fit", "train": "fit", "predict": "fit"}
DRIVERS = ["fit_lae_logit_gp", "fit_lae_logit_mult_gp"]
# the SE regression at the default bandwidth grid and Adam schedule
SE = "fit_se_regression_gp"
SE_CFG = ft.FitConfig(graph=ft.GraphConfig(s=48, r=3, K=16, kernel="se"), sigma=1e-5, dtype=F64)
SE_TREE = {"fit": None, "upload": "fit", "subsample": "fit", "graph": "fit", "knn": "graph",
           "grid": "fit", "train": "fit", "predict": "fit"}
N_GRID = len(ft.config.default_a2s())
# the out-of-core binary fit: its layers, each once, and its chunks
STREAM_TREE = {"fit": None, "reservoir": "fit", "subsample": "fit", "graph": "fit",
               "spectrum": "fit", "train": "fit", "predict": "fit"}
STREAM_ROWS = 250


def _data(driver):
    if driver == "fit_lae_logit_gp":
        return torus_rings(n=900, m_train=80, seed=3)
    if driver == SE:
        return spiral(n=900, m_train=60, seed=6)
    return mnist_like(n=900, n_classes=4, d=8, m_train=80, seed=4)


def _fit(driver, ds, report=None):
    kw = {} if report is None else dict(report=report)
    return getattr(ft, driver)(torch.Generator().manual_seed(5), ds.x_train, ds.y_train,
                               ds.x_test, cfg=SE_CFG if driver == SE else CFG, device="cpu",
                               **kw)


def _same_bits(a, b):
    for name in ("y_train", "y_test", "posterior_mean", "posterior_cov"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert a.pars.keys() == b.pars.keys()
    for k in a.pars:
        assert np.array_equal(a.pars[k], b.pars[k]), k
    assert a.obj == b.obj
    assert torch.equal(a.eigenpair.vectors, b.eigenpair.vectors)


@pytest.mark.parametrize("driver", DRIVERS)
def test_recording_changes_no_output_bit_and_off_records_nothing(driver):
    ds = _data(driver)
    with recording() as idle:
        pass
    off = _fit(driver, ds)
    with recording() as rec:
        on = _fit(driver, ds)
    after = _fit(driver, ds)
    _same_bits(off, on)
    _same_bits(off, after)
    assert idle.spans == [] and idle.counts == {}
    assert rec.fits() == [1] and len(rec.spans) == len(TREE)
    assert metrics._ON is False and metrics._OPEN == []
    # off, every span is the one shared no-op context
    assert span("fit") is span("predict")


@pytest.mark.parametrize("driver", DRIVERS)
def test_spans_form_one_tree_under_fit(driver):
    with recording() as rec:
        _fit(driver, _data(driver))
    names = Counter(s.name for s in rec.spans)
    assert names == Counter(TREE.keys()), names
    by_id = {s.id: s for s in rec.spans}
    by_name = {s.name: s for s in rec.spans}
    for s in rec.spans:
        assert s.fit == 1
        assert s.t0 <= s.t1
        if TREE[s.name] is None:
            assert s.parent is None
            continue
        parent = by_id[s.parent]
        assert parent.name == TREE[s.name], (s.name, parent.name)
        assert parent.t0 <= s.t0 and s.t1 <= parent.t1, s.name
    # siblings in the order the fit runs them, none overlapping
    order = ["upload", "subsample", "graph", "spectrum", "train", "predict"]
    for a, b in zip(order, order[1:]):
        assert by_name[a].t1 <= by_name[b].t0, (a, b)


_READS = ("__bool__", "__int__", "__float__", "__index__", "item", "numpy", "tolist", "cpu")


@pytest.mark.parametrize("driver", DRIVERS + [SE])
def test_host_syncs_count_every_blocking_read(driver, monkeypatch):
    """Every read of a tensor's value by the host, seen by patching the
    tensor's read methods (``cpu()`` reads only off a CPU tensor), goes
    through ``to_host``: the counter and the patch agree."""
    ds = _data(driver)
    seen = Counter()

    def patched(name):
        orig = getattr(torch.Tensor, name)

        def read(self, *args, **kwargs):
            if name != "cpu" or self.device.type != "cpu":
                seen[name] += 1
            return orig(self, *args, **kwargs)
        return read

    for name in _READS:
        monkeypatch.setattr(torch.Tensor, name, patched(name))
    before = metrics.COUNTS["host_syncs"]
    with recording() as rec:
        _fit(driver, ds)
    syncs = metrics.COUNTS["host_syncs"] - before
    monkeypatch.undo()
    assert syncs == sum(seen.values()) > 0, (syncs, seen)
    assert rec.fit_counts(1)["host_syncs"] == syncs


@pytest.mark.parametrize("driver", DRIVERS + [SE])
def test_each_fit_keeps_its_own_counts(driver):
    """A fit appends one entry to ``FIT_COUNTS``: what the store gained in
    it, which is what the record attributes to that fit, and its call."""
    ds = _data(driver)
    before = Counter(metrics.COUNTS)
    n = len(metrics.FIT_COUNTS)
    with recording() as rec:
        _fit(driver, ds)
    assert len(metrics.FIT_COUNTS) == min(n + 1, metrics.FIT_COUNTS.maxlen)
    last = metrics.FIT_COUNTS[-1]
    assert last == Counter(metrics.COUNTS) - before
    assert last - Counter(fits=1) == rec.fit_counts(1) and last["fits"] == 1
    assert last["host_syncs"] > 0


@pytest.fixture(scope="module")
def streamed_file(tmp_path_factory):
    """The torus of the LAE drivers' tests as a float32 FLGP0001 file, the
    train rows first, and its split."""
    ds = _data("fit_lae_logit_gp")
    path = str(tmp_path_factory.mktemp("streamed") / "x.flgp")
    native.write_matrix(path, np.concatenate([ds.x_train, ds.x_test]).astype(np.float32))
    return path, ds


def _fit_streamed(streamed_file):
    path, ds = streamed_file
    with native.MatrixFile(path) as mat:
        return streaming.fit_lae_logit_gp_streamed(
            torch.Generator().manual_seed(5), mat, ds.y_train, np.arange(len(ds.y_train)),
            cfg=CFG, chunk_rows=STREAM_ROWS, device="cpu")


def test_streamed_fit_changes_no_output_bit_when_recording(streamed_file):
    off = _fit_streamed(streamed_file)
    with recording() as rec:
        on = _fit_streamed(streamed_file)
    after = _fit_streamed(streamed_file)
    for name in ("labels", "probs", "post_mean", "post_var"):
        assert torch.equal(getattr(off, name), getattr(on, name)), name
        assert torch.equal(getattr(off, name), getattr(after, name)), name
    assert torch.equal(off.pars["t"], on.pars["t"]) and torch.equal(off.pars["obj"], on.pars["obj"])
    assert rec.fits() == [1] and len(rec.spans) == len(STREAM_TREE)


def test_streamed_spans_form_one_tree_under_fit(streamed_file):
    with recording() as rec:
        _fit_streamed(streamed_file)
    assert Counter(s.name for s in rec.spans) == Counter(STREAM_TREE.keys())
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        assert s.fit == 1 and s.t0 <= s.t1
        if STREAM_TREE[s.name] is None:
            assert s.parent is None
            continue
        parent = by_id[s.parent]
        assert parent.name == STREAM_TREE[s.name], (s.name, parent.name)
        assert parent.t0 <= s.t0 and s.t1 <= parent.t1, s.name
    # the layers in the order the fit runs them, none overlapping
    order = sorted((s for s in rec.spans if s.parent is not None), key=lambda s: s.t0)
    assert [s.name for s in order] == ["reservoir", "subsample", "graph", "spectrum", "train",
                                       "predict"]
    assert all(a.t1 <= b.t0 for a, b in zip(order, order[1:]))


def test_streamed_fit_counts_three_passes_of_chunks_in_their_layers(streamed_file):
    """Each of the three passes over the file (the reservoir's, the count
    pass, the graph pass) hands on ⌈n / chunk_rows⌉ chunks; the record and the
    fit's own entry of ``FIT_COUNTS`` agree."""
    n = len(streamed_file[1].y_train) + len(streamed_file[1].y_test)
    with recording() as rec:
        _fit_streamed(streamed_file)
    chunks = 3 * math.ceil(n / STREAM_ROWS)
    assert rec.fit_counts(1)["stream_chunks"] == metrics.FIT_COUNTS[-1]["stream_chunks"] == chunks
    name_of = {s.id: s.name for s in rec.spans}
    where = Counter()
    for (_, sid), c in rec.counts.items():
        where[name_of.get(sid)] += c["stream_chunks"]
    assert +where == Counter(reservoir=chunks // 3, subsample=chunks // 3, graph=chunks // 3)


def test_streamed_host_syncs_count_every_read_and_no_buffer_wait(streamed_file, monkeypatch):
    """``host_syncs`` counts the reads a patch of the tensor's read methods
    sees, and nothing else: on the CPU the passes read through the loader, so
    no pinned buffer is waited on (``stream_buffer_waits`` stays where it
    was; on the card the two are counted apart, ``tests/test_torch_cuda.py``)."""
    seen = Counter()

    def patched(name):
        orig = getattr(torch.Tensor, name)

        def read(self, *args, **kwargs):
            if name != "cpu" or self.device.type != "cpu":
                seen[name] += 1
            return orig(self, *args, **kwargs)
        return read

    for name in _READS:
        monkeypatch.setattr(torch.Tensor, name, patched(name))
    before = Counter(metrics.COUNTS)
    _fit_streamed(streamed_file)
    monkeypatch.undo()
    syncs = metrics.COUNTS["host_syncs"] - before["host_syncs"]
    assert syncs == sum(seen.values()) > 0, (syncs, seen)
    assert metrics.COUNTS["stream_buffer_waits"] == before["stream_buffer_waits"]


def test_se_regression_changes_no_output_bit_when_recording():
    ds = _data(SE)
    off = _fit(SE, ds)
    with recording() as rec:
        on = _fit(SE, ds)
    _same_bits(off, on)
    _same_bits(off, _fit(SE, ds))
    assert rec.fits() == [1] and len(rec.spans) == len(SE_TREE) + N_GRID - 1


def test_se_regression_spans_form_one_tree_under_fit():
    with recording() as rec:
        _fit(SE, _data(SE))
    names = Counter(s.name for s in rec.spans)
    assert names == Counter(dict(dict.fromkeys(SE_TREE, 1), grid=N_GRID)), names
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if SE_TREE[s.name] is None:
            assert s.parent is None
            continue
        parent = by_id[s.parent]
        assert parent.name == SE_TREE[s.name], (s.name, parent.name)
        assert parent.t0 <= s.t0 and s.t1 <= parent.t1, s.name
    # the layers in the order the fit runs them, none overlapping
    order = sorted((s for s in rec.spans if s.parent == 1), key=lambda s: s.t0)
    assert [s.name for s in order] == (["upload", "subsample", "graph"] + ["grid"] * N_GRID
                                       + ["train", "predict"])
    assert all(a.t1 <= b.t0 for a, b in zip(order, order[1:]))


def test_se_regression_counts_its_adam_steps_and_grid_spectra_in_their_layers():
    with recording() as rec:
        _fit(SE, _data(SE))
    name_of = {s.id: s.name for s in rec.spans}
    counts = rec.fit_counts(1)
    assert counts["adam_steps"] == ft.TrainConfig().adam_steps == SE_CFG.train.adam_steps
    assert counts["grid_spectra"] == N_GRID
    where = {}
    for (_, sid), c in rec.counts.items():
        for k in c:
            where.setdefault(k, set()).add(name_of.get(sid))
    assert where["adam_steps"] == {"train"}
    assert where["grid_spectra"] == {"grid"}
    assert where["lloyd_rounds"] == {"subsample"}


@pytest.mark.parametrize("iters,rounds", [(100, 3), (2, 2), (1, 1)])
def test_lloyd_rounds_count_the_iterations_run(iters, rounds):
    """Points 0, 1, 10, 11 from centers 0 and 1: the assignment changes in
    rounds 1 and 2 and holds in round 3, where Lloyd stops."""
    X = torch.tensor([[0.0], [1.0], [10.0], [11.0]], dtype=F64)
    before = metrics.COUNTS["lloyd_rounds"]
    centers, counts, _ = kmeans.lloyd(X, X[:2].clone(), iters)
    assert metrics.COUNTS["lloyd_rounds"] - before == rounds
    if iters == 100:
        assert centers[:, 0].tolist() == [0.5, 10.5] and counts.tolist() == [2.0, 2.0]


# Lloyd's assignment: K1 at r = 1 for float32 on the card up to the crossover
# in d, the blocked distance matrix everywhere else
_CROSSOVER = kmeans._KERNEL_ASSIGN_MAX_D
_KERNEL = [("cuda", torch.float32, d) for d in sorted({1, 2, 3, 16, 64, _CROSSOVER})]
_PLAIN = [("cpu", torch.float32, 2), ("cpu", torch.float32, 3), ("cpu", F64, 2),
          ("cuda", F64, 2), ("cuda", F64, 3), ("cuda", torch.float32, _CROSSOVER + 1),
          ("cuda", torch.float32, 128), ("cuda", torch.float32, 256), ("cuda", torch.float32, 784)]


@pytest.mark.parametrize("device_type,dtype,d,kernel",
                         [(*c, True) for c in _KERNEL] + [(*c, False) for c in _PLAIN])
def test_assign_takes_k1_for_float32_on_the_card_up_to_the_crossover(device_type, dtype, d,
                                                                      kernel):
    assert kmeans.assign_on_kernel(device_type, dtype, d) is kernel


def test_assign_takes_k1_at_every_d_up_to_the_crossover():
    assert 64 <= _CROSSOVER < 128
    assert all(kmeans.assign_on_kernel("cuda", torch.float32, d) for d in range(1, _CROSSOVER + 1))


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("iters,rounds", [(100, 3), (2, 2)])
def test_lloyd_on_the_cpu_counts_no_kernel_round(dtype, iters, rounds):
    X = torch.tensor([[0.0], [1.0], [10.0], [11.0]], dtype=dtype)
    before = Counter(metrics.COUNTS)
    kmeans.lloyd(X, X[:2].clone(), iters)
    assert metrics.COUNTS["lloyd_rounds"] - before["lloyd_rounds"] == rounds
    assert metrics.COUNTS["lloyd_kernel_rounds"] == before["lloyd_kernel_rounds"]


# k-means‖'s weighted k-means++: the kernel for float32 on the card up to the
# candidates one block's shared memory holds, the plain loop everywhere else
_MAX_C = hk.KMEANSPP_MAX_C
_SEED_KERNEL = [("cuda", torch.float32, C) for C in (1, 75, 1201, 2049, 4097, _MAX_C)]
_SEED_PLAIN = [("cpu", torch.float32, 2049), ("cpu", F64, 2049), ("cuda", F64, 2049),
               ("cuda", F64, 75), ("cuda", torch.float32, _MAX_C + 1)]


@pytest.mark.parametrize("device_type,dtype,C,kernel",
                         [(*c, True) for c in _SEED_KERNEL] + [(*c, False) for c in _SEED_PLAIN])
def test_seed_takes_the_kernel_for_float32_on_the_card_up_to_its_shared_memory(
        device_type, dtype, C, kernel):
    assert kmeans.seed_on_kernel(device_type, dtype, C) is kernel


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_seedings_count_one_a_weighted_reduction(rng, dtype):
    """One ``seedings`` a k-means‖ seeding, on the CPU's plain loop (no
    launch); none from the k-means++ and random seedings, which have no
    candidates to reduce."""
    X = torch.as_tensor(rng.normal(size=(1200, 2)), dtype=dtype)
    for init, seeded in (("kmeans||", 1), ("kmeans++", 0), ("random", 0), ("auto", 1)):
        before = Counter(metrics.COUNTS)
        kmeans.kmeans(torch.Generator().manual_seed(2), X, 64, iters=3, init=init)
        assert metrics.COUNTS["seedings"] - before["seedings"] == seeded, init
        assert hk.LAUNCHES["weighted_kmeanspp"] == before["kernel_launches:weighted_kmeanspp"]


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_update_takes_k1_s_int32_assignments_bit_for_bit(dtype):
    """K1 gives int32 indices where the plain pass gives int64: the centers,
    the counts and the early exit's comparison read them alike."""
    g = torch.Generator().manual_seed(3)
    X = torch.randn((500, 3), generator=g, dtype=dtype)
    old = X[:40].clone()
    assign, _ = kmeans._assign_plain(X, old)
    assign[assign == 7] = 8                     # an empty cluster keeps its old center
    c64, n64 = kmeans._update(X, assign, 40, old)
    c32, n32 = kmeans._update(X, assign.to(torch.int32), 40, old)
    assert torch.equal(c64, c32) and torch.equal(n64, n32) and n32[7] == 0
    assert torch.equal(c32[7], old[7])
    assert not bool(torch.any(assign.to(torch.int32) != assign))


def test_newton_rounds_count_the_rounds_run():
    """One lane: as many rounds as its iterations; lanes in one solve: as
    many as the slowest lane's."""
    g = torch.Generator().manual_seed(0)
    A = torch.randn((3, 20, 20), generator=g, dtype=F64)
    C = A @ A.mT / 20 + 1e-3 * torch.eye(20, dtype=F64)
    Y = (torch.rand((3, 20), generator=g, dtype=F64) > 0.5).to(F64)
    N = torch.ones(20, dtype=F64)
    before = metrics.COUNTS["newton_rounds"]
    _, it, _ = gpc.gpc_marginal_log_likelihood_status(C[0], Y[0], N)
    assert metrics.COUNTS["newton_rounds"] - before == int(it) > 1
    before = metrics.COUNTS["newton_rounds"]
    _, its, _ = gpc.gpc_marginal_log_likelihood_status(C, Y, N)
    assert metrics.COUNTS["newton_rounds"] - before == int(its.max())


@pytest.mark.parametrize("classes", [1, 4, 10])
def test_a_fit_counts_one_t_search_of_its_classes(classes):
    """A fit trains its classes in one t-search: ``t_searches`` 1 and
    ``t_search_problems`` the number of classes, one for a binary fit."""
    if classes == 1:
        driver, ds = "fit_lae_logit_gp", _data("fit_lae_logit_gp")
    else:
        driver = "fit_lae_logit_mult_gp"
        ds = mnist_like(n=900, n_classes=classes, d=8, m_train=80, seed=4)
    with recording() as rec:
        res = _fit(driver, ds)
    got = rec.fit_counts(1)
    assert (got["t_searches"], got["t_search_problems"]) == (1, classes)
    assert np.asarray(res.pars["t"]).size == classes


def test_a_joint_t_search_counts_the_slowest_lane_s_rounds(monkeypatch):
    """The joint training's ``newton_rounds`` are the sum over its
    evaluations of the slowest lane's iterations, and fewer than the sum over
    the classes' lone trainings."""
    from flgp_tpu_torch.fit import drivers
    from flgp_tpu_torch.fit import multiclass as mc

    ds = _data("fit_lae_logit_mult_gp")
    X = torch.as_tensor(np.concatenate([ds.x_train, ds.x_test]), dtype=F64)
    eig, _ = ft.fit.spectral.build_spectrum(torch.Generator().manual_seed(5), X, CFG.graph)
    m = len(ds.y_train)
    aug = mc.one_hot_labels(torch.as_tensor(ds.y_train, dtype=F64), 4)
    its = []
    iterate = gpc._iterate_lanes

    def iterate_recorded(*args):
        st = iterate(*args)
        its.append(int(st.it.max()))
        return st

    monkeypatch.setattr(gpc, "_iterate_lanes", iterate_recorded)
    before = metrics.COUNTS["newton_rounds"]
    mc._train_mult(eig, aug, m, CFG.graph.K, CFG)
    joint = metrics.COUNTS["newton_rounds"] - before
    assert joint == sum(its) > 0
    before = metrics.COUNTS["newton_rounds"]
    N = torch.ones(m, dtype=F64)
    for j in range(4):
        drivers._train_gpc(eig, aug[:, j], N, slice(0, m), CFG.graph.K, CFG)
    assert joint < metrics.COUNTS["newton_rounds"] - before


def test_a_binary_fit_makes_the_one_problem_training_s_rounds_and_syncs(monkeypatch):
    """A binary fit, one problem of the problem axis, makes the one-problem
    training's Newton rounds and host syncs to the count, and its bits."""
    import optimize_parent

    from flgp_tpu_torch.fit import drivers

    ds = _data("fit_lae_logit_gp")
    got = _fit("fit_lae_logit_gp", ds)
    counts = metrics.FIT_COUNTS[-1]
    monkeypatch.setattr(drivers, "_train_gpc", optimize_parent.train_gpc)
    ref = _fit("fit_lae_logit_gp", ds)
    ref_counts = metrics.FIT_COUNTS[-1]
    _same_bits(got, ref)
    for k in ("newton_rounds", "host_syncs"):
        assert counts[k] == ref_counts[k] > 0, k
    assert (counts["t_searches"], ref_counts["t_searches"]) == (1, 0)


@pytest.mark.parametrize("driver", DRIVERS)
def test_counts_land_in_their_layers(driver):
    with recording() as rec:
        _fit(driver, _data(driver))
    name_of = {s.id: s.name for s in rec.spans}
    # a fit is counted as it is called, before its span opens
    assert rec.counts.pop((None, None)) == Counter(fits=1)
    where = {}
    for (fit, sid), c in rec.counts.items():
        assert fit == 1
        for k in c:
            where.setdefault(k, set()).add(name_of[sid])
    assert where["lloyd_rounds"] == {"subsample"}
    assert where["pg_rounds"] == {"predict"}
    assert where["newton_rounds"] == {"train", "predict"}
    assert where["t_searches"] == where["t_search_problems"] == {"train"}
    assert {"subsample", "train", "predict"} <= where["host_syncs"]


@pytest.mark.parametrize("driver", DRIVERS)
def test_every_span_is_a_profiler_range(driver, tmp_path):
    ds = _data(driver)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with recording() as rec, torch.profiler.profile(activities=acts) as prof:
        _fit(driver, ds)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = Counter(e["name"][5:] for e in events
                     if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                     and e["name"].startswith("flgp:"))
    assert ranges == Counter(s.name for s in rec.spans) == Counter(TREE.keys())


def test_report_stages_are_spans_while_recording():
    ds = _data("fit_lae_logit_gp")
    report = MetricsReport()
    with recording() as rec:
        _fit("fit_lae_logit_gp", ds, report=report)
    assert [st.name for st in report.stages] == ["spectrum", "train", "predict"]
    by_id = {s.id: s for s in rec.spans}
    stage = {s.name: s for s in rec.spans if s.name.startswith("report:")}
    assert set(stage) == {"report:spectrum", "report:train", "report:predict"}
    for inner, outer in (("subsample", "report:spectrum"), ("spectrum", "report:spectrum"),
                         ("train", "report:train"), ("predict", "report:predict")):
        (s,) = [s for s in rec.spans if s.name == inner]
        assert by_id[s.parent].name == outer
    for st in report.stages:
        s = stage["report:" + st.name]
        assert abs(st.wall_s - (s.t1 - s.t0) * 1e-9) < 1e-3 and st.wall_s > 0


def test_to_host_reads_as_the_builtins_do():
    before = metrics.COUNTS["host_syncs"]
    assert to_host(torch.tensor(True)) is True
    i = to_host(torch.argmin(torch.tensor([3.0, 1.0])))
    assert i == 1 and type(i) is int
    f = torch.tensor(0.1, dtype=torch.float32)
    assert to_host(f) == float(f) and type(to_host(f)) is float
    a = to_host(f, array=True)
    assert isinstance(a, np.ndarray) and a.shape == () and a.dtype == np.float32
    assert to_host(torch.arange(3)).tolist() == [0, 1, 2]
    assert metrics.COUNTS["host_syncs"] - before == 6


def test_the_counter_views_read_the_one_store():
    hk.reset_launches()
    nuts.reset_stats()
    count("kernel_launches:knn", 2)
    count("nuts:transitions")
    assert hk.LAUNCHES["knn"] == 2 and metrics.COUNTS["kernel_launches:knn"] == 2
    assert nuts.STATS["transitions"] == 1 and nuts.STATS["host_syncs"] == 0
    assert {k: v for k, v in hk.LAUNCHES.items() if v} == {"knn": 2}
    before = dict(hk.LAUNCHES)
    assert hk.LAUNCHES == before
    with pytest.raises(KeyError):
        hk.LAUNCHES["no_such_kernel"]
    syncs = metrics.COUNTS["host_syncs"]
    hk.reset_launches()
    nuts.reset_stats()
    assert all(v == 0 for v in hk.LAUNCHES.values()) and nuts.STATS["transitions"] == 0
    assert metrics.COUNTS["host_syncs"] == syncs           # the other counters run on
    assert not hasattr(gpc, "STATS") and not hasattr(gpc, "reset_stats")


def test_recorder_is_not_reentrant_and_closes_cleanly():
    with recording() as rec:
        with pytest.raises(RuntimeError):
            with recording():
                pass
        with span("fit"):
            with span("train"):
                count("newton_rounds", 3)
            with span("fit"):                   # a fit inside a fit is one of its spans
                pass
        with span("fit"):
            pass
        count("pg_rounds")
    assert rec.fits() == [1, 2]
    assert [s.name for s in rec.spans] == ["train", "fit", "fit", "fit"]
    assert rec.fit_counts(1) == Counter(newton_rounds=3)
    assert rec.fit_counts(None) == Counter(pg_rounds=1)
    assert rec.seconds("fit", fit=1) > 0 and metrics._OPEN == []
