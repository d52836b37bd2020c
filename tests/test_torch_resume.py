"""Kill-and-resume: flgp_tpu_torch.utils.checkpoint and the segmented HMC of
flgp_tpu_torch.inference.resume.

A checkpoint is written under a temporary name and moved into place, so a
killed write is never read back as a finished one; segmented HMC seeds each
segment afresh from (seed, segment index), so a run resumed from copied
``seg_*``/``phase_*`` directories returns the draws of an uninterrupted run
bit for bit (as tests/test_resume.py holds the reference).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from flgp_tpu_torch.inference import resume
from flgp_tpu_torch.inference.resume import run_hmc_checkpointed
from flgp_tpu_torch.types import EigenPair
from flgp_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)


def _logprob():
    rng = np.random.default_rng(0)
    dim = 6
    A = rng.normal(size=(dim, dim))
    prec = torch.tensor(A @ A.T / dim + np.eye(dim))

    def lp(x):
        return -0.5 * torch.sum((x @ prec) * x, dim=-1)

    return lp, dim


def _x0(dim, dtype=torch.float64):
    return 0.5 * torch.randn((4, dim), generator=torch.Generator().manual_seed(1), dtype=dtype)


RUN = dict(n_warmup=16, n_samples=48, segment=16, n_leapfrog=8)


def _copy(src, dst, names):
    os.makedirs(dst)
    for name in names:
        shutil.copytree(src / name, dst / name)


def test_save_and_load_keep_every_dtype_and_the_tree(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3) / 7,
            "b": {"c": torch.tensor([1.0, 2.0], dtype=torch.float64),
                  "d": torch.tensor([3, 4], dtype=torch.int64)},
            "e": [torch.tensor([True, False]), 2.5],
            "f": np.arange(3, dtype=np.int32)}
    ckpt.save_pytree(str(tmp_path / "x"), tree)
    assert ckpt.is_saved(str(tmp_path / "x"))
    got = ckpt.load_pytree(str(tmp_path / "x"))
    assert torch.equal(got["a"], tree["a"]) and got["a"].dtype == torch.float32
    assert torch.equal(got["b"]["c"], tree["b"]["c"]) and got["b"]["d"].dtype == torch.int64
    assert torch.equal(got["e"][0], tree["e"][0]) and got["e"][1] == 2.5
    assert got["f"].dtype == torch.int32 and got["f"].tolist() == [0, 1, 2]
    like = {"a": torch.zeros((2, 3), dtype=torch.float64), "b": {"c": torch.zeros(2),
                                                                 "d": torch.zeros(2)},
            "e": [torch.zeros(2), 0.0], "f": torch.zeros(3, dtype=torch.int64)}
    cast = ckpt.load_pytree(str(tmp_path / "x"), like=like)
    assert cast["a"].dtype == torch.float64 and cast["b"]["c"].dtype == torch.float32
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_pytree(str(tmp_path / "x"), like={**like, "a": torch.zeros(6)})
    # saving again overwrites
    ckpt.save_pytree(str(tmp_path / "x"), {"a": torch.ones(1)})
    assert list(ckpt.load_pytree(str(tmp_path / "x"))) == ["a"]
    assert os.listdir(tmp_path / "x") == [ckpt.FILE]


def test_save_and_load_spectrum(tmp_path):
    eig = EigenPair(torch.linspace(1.0, 0.5, 5, dtype=torch.float64),
                    torch.randn((40, 5), generator=torch.Generator().manual_seed(0)))
    anchors, counts = torch.randn((10, 2)), torch.arange(10.0)
    ckpt.save_spectrum(str(tmp_path / "spec"), eig, anchors, counts)
    got, a, c = ckpt.load_spectrum(str(tmp_path / "spec"))
    assert torch.equal(got.values, eig.values) and torch.equal(got.vectors, eig.vectors)
    assert torch.equal(a, anchors) and torch.equal(c, counts)


def test_a_killed_write_leaves_the_last_checkpoint_and_no_temporary(tmp_path, monkeypatch):
    path = str(tmp_path / "seg_0")
    ckpt.save_pytree(path, {"v": torch.zeros(3)})

    def killed(obj, fh):
        fh.write(b"\x80\x02partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(torch, "save", killed)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save_pytree(path, {"v": torch.ones(3)})
    assert os.listdir(path) == [ckpt.FILE]
    assert torch.equal(ckpt.load_pytree(path)["v"], torch.zeros(3))
    with pytest.raises(KeyboardInterrupt):
        ckpt.save_pytree(str(tmp_path / "seg_1"), {"v": torch.ones(3)})
    assert not ckpt.is_saved(str(tmp_path / "seg_1"))


def test_a_truncated_temporary_file_is_not_a_checkpoint(tmp_path):
    ckpt.save_pytree(str(tmp_path / "full"), {"v": torch.arange(1000.0)})
    data = (tmp_path / "full" / ckpt.FILE).read_bytes()
    os.makedirs(tmp_path / "cut")
    (tmp_path / "cut" / (ckpt.FILE + ".abc123.tmp")).write_bytes(data[: len(data) // 2])
    assert not ckpt.is_saved(str(tmp_path / "cut"))
    with pytest.raises(FileNotFoundError):
        ckpt.load_pytree(str(tmp_path / "cut"))


def test_phase_generators_are_a_function_of_seed_and_index():
    def draw(seed, i):
        return torch.rand(4, generator=resume.phase_generator(seed, i, "cpu"))

    assert torch.equal(draw(3, 0), draw(3, 0))
    assert not torch.equal(draw(3, 0), draw(3, 1))
    assert not torch.equal(draw(3, 1), draw(4, 1))


def test_two_fresh_runs_are_equal_bit_for_bit(tmp_path):
    lp, dim = _logprob()
    run_a = run_hmc_checkpointed(0, lp, _x0(dim), str(tmp_path / "a"), **RUN)
    run_b = run_hmc_checkpointed(0, lp, _x0(dim), str(tmp_path / "b"), **RUN)
    assert run_a.samples.shape == (48, 4, dim) and run_a.accept_prob.shape == (48, 4)
    assert torch.equal(run_a.samples, run_b.samples)
    assert torch.equal(run_a.accept_prob, run_b.accept_prob)
    assert float(run_a.accept_prob.mean()) > 0.5
    # another seed is another stream
    run_c = run_hmc_checkpointed(1, lp, _x0(dim), str(tmp_path / "c"), **RUN)
    assert not torch.equal(run_a.samples, run_c.samples)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kill_and_resume_bit_exact(tmp_path, dtype):
    """A kill after 2 of 3 segments: only their checkpoints are copied."""
    lp, dim = _logprob()
    x0 = _x0(dim, dtype)
    full = run_hmc_checkpointed(0, lambda x: lp(x.double()).to(x.dtype), x0,
                                str(tmp_path / "full"), **RUN)
    assert full.samples.dtype == dtype
    _copy(tmp_path / "full", tmp_path / "resumed", ["seg_0", "phase_0", "seg_1", "phase_1"])
    resumed = run_hmc_checkpointed(0, lambda x: lp(x.double()).to(x.dtype), x0,
                                   str(tmp_path / "resumed"), **RUN)
    assert torch.equal(full.samples, resumed.samples)
    assert torch.equal(full.step, resumed.step) and torch.equal(full.inv_mass, resumed.inv_mass)


@pytest.mark.parametrize("cut", ["temporary files", "segment without its phase"])
def test_resume_redoes_a_segment_that_did_not_finish(tmp_path, cut):
    """A segment whose files are only truncated temporaries, or whose draws
    landed but whose phase did not, is run again: the result is still the
    uninterrupted run's, bit for bit."""
    lp, dim = _logprob()
    full = run_hmc_checkpointed(0, lp, _x0(dim), str(tmp_path / "full"), **RUN)
    _copy(tmp_path / "full", tmp_path / "resumed", ["seg_0", "phase_0"])
    if cut == "temporary files":
        for name in ("seg_1", "phase_1"):
            data = (tmp_path / "full" / name / ckpt.FILE).read_bytes()
            os.makedirs(tmp_path / "resumed" / name)
            (tmp_path / "resumed" / name / (ckpt.FILE + ".x1.tmp")).write_bytes(data[:100])
    else:
        shutil.copytree(tmp_path / "full" / "seg_1", tmp_path / "resumed" / "seg_1")
    resumed = run_hmc_checkpointed(0, lp, _x0(dim), str(tmp_path / "resumed"), **RUN)
    assert torch.equal(full.samples, resumed.samples)
    assert ckpt.is_saved(str(tmp_path / "resumed" / "phase_1"))


def test_warmup_and_segment_pieces():
    lp, dim = _logprob()
    g = torch.Generator().manual_seed(5)
    phase = resume.hmc_warmup(g, lp, _x0(dim), n_warmup=20, n_leapfrog=8)
    assert phase.x.shape == (4, dim) and phase.step.shape == (4,)
    assert phase.inv_mass.shape == (4, dim) and bool(torch.all(phase.inv_mass > 0))
    draws, aps, nxt = resume.hmc_segment(g, lp, phase, n_sweeps=7, n_leapfrog=8)
    assert draws.shape == (7, 4, dim) and aps.shape == (7, 4)
    assert torch.equal(nxt.x, draws[-1]) and torch.equal(nxt.step, phase.step)
