"""The PyTorch port's PGO (dense, and PCG with both preconditioners)
against the JAX package's optimize_pose_graph on the synthetic graphs of
tests/test_pgo.py: node poses at atol 1e-4, final loss at rtol 1e-3. Every
case pads to the same buffers and window bucket, so the JAX solver compiles
once for the file per solver configuration."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pgo import _stress_graph, make_chain, pad
from vista_slam_tpu.ops import sim3 as jsim3
from vista_slam_tpu.slam.pgo import PGOConfig as JPGOConfig
from vista_slam_tpu.slam.pgo import optimize_pose_graph as joptimize
from vista_slam_tpu_torch.slam import pgo
from vista_slam_tpu_torch.slam.pgo import PGOConfig, optimize_pose_graph
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


N_PAD, E_PAD = 48, 64  # <= 32 optimised nodes in every dense case: one window bucket


def _arrays(init, edges, meas, confs, opt_mask, n_pad, e_pad):
    ident = np.asarray(jsim3.identity())
    e = len(edges)
    return (np.array(pad(np.asarray(init), n_pad, ident)),
            np.array(pad(np.asarray(edges, np.int32), e_pad, np.zeros(2, np.int32))),
            np.array(pad(np.asarray(meas), e_pad, ident)),
            np.array(pad(np.asarray(confs, np.float32), e_pad, np.zeros(7, np.float32))),
            np.array(pad(np.ones(e, bool), e_pad, np.zeros((), bool))),
            np.array(pad(np.asarray(opt_mask, bool), n_pad, np.zeros((), bool))))


def _chain_loop():
    gt, meas, edges = make_chain(8, jax.random.PRNGKey(0), noise=0.08)
    init = [np.asarray(jsim3.identity())]
    for k in range(1, 8):
        init.append(np.asarray(jsim3.mul(jnp.asarray(init[-1]), meas[k - 1])))
    edges = list(map(tuple, edges)) + [(7, 0)]
    meas = np.concatenate([np.asarray(meas), np.asarray(jsim3.mul(jsim3.inv(gt[0]), gt[7]))[None]])
    mask = np.ones(8, bool)
    mask[0] = False
    return np.stack(init), edges, meas, np.ones((len(edges), 7)), mask, N_PAD, E_PAD


def _window():
    init, edges, meas, confs, _, n_pad, e_pad = _chain_loop()
    mask = np.zeros(8, bool)
    mask[4:] = True  # only the last views move
    return init, edges, meas, confs, mask, n_pad, e_pad


def _scale_edge():
    z = np.array(jsim3.identity())
    z[7] = 2.0
    init = np.stack([np.asarray(jsim3.identity())] * 2)
    return init, [(1, 0)], z[None], np.ones((1, 7)), np.asarray([False, True]), N_PAD, E_PAD


def _stress():
    _, init, edges, meas, confs, mask = _stress_graph(30)
    return (np.asarray(init), edges, np.stack([np.asarray(m) for m in meas]),
            np.stack(confs), mask, N_PAD, E_PAD)


def _stress_long():
    """A 46-node drifting loop, closed by one distant edge, with junk edges:
    PCG only (past the dense window bucket of the other cases)."""
    _, init, edges, meas, confs, mask = _stress_graph(46)
    return (np.asarray(init), edges, np.stack([np.asarray(m) for m in meas]),
            np.stack(confs), mask, N_PAD, E_PAD)


CASES = [_chain_loop, _window, _scale_edge, _stress]
IDS = ["chain_loop", "window", "scale_edge", "stress_30"]


@functools.cache
def _case_arrays(case):
    """Each case's padded arrays, built once for the file (the graphs are
    made with JAX ops, op by op)."""
    return _arrays(*case())


def _check_against_jax(arrays, jcfg, cfg):
    want, winfo = joptimize(*map(jnp.asarray, arrays), jcfg)
    got, info = optimize_pose_graph(*map(torch.from_numpy, arrays), cfg)
    want = np.asarray(want)
    assert np.isfinite(want).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert np.isfinite(info["loss"]) and np.isfinite(float(winfo["loss"]))
    np.testing.assert_allclose(info["loss"], float(winfo["loss"]), rtol=1e-3,
                               atol=1e-9)
    np.testing.assert_allclose(info["loss0"], float(winfo["loss0"]), rtol=1e-5)
    assert info["loss"] <= info["loss0"]
    return info


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dense_pgo_matches_jax(case):
    info = _check_against_jax(_case_arrays(case), JPGOConfig(max_steps=25, solver="dense"),
                              PGOConfig(max_steps=25, solver="dense"))
    assert info["solver"] == "dense" and info["cg_iters"] == []


@pytest.mark.parametrize("precond", ["tridiag", "jacobi"])
@pytest.mark.parametrize("case", CASES + [_stress_long], ids=IDS + ["stress_46"])
def test_pcg_pgo_matches_jax(case, precond):
    info = _check_against_jax(
        _case_arrays(case), JPGOConfig(max_steps=25, solver="pcg", pcg_precond=precond),
        PGOConfig(max_steps=25, solver="pcg", pcg_precond=precond))
    assert info["solver"] == "pcg" and len(info["cg_iters"]) == info["steps"]
    assert all(0 <= c <= PGOConfig().cg_iters for c in info["cg_iters"])


def test_auto_takes_pcg_past_dense_max():
    """"auto" with more optimised nodes than dense_max solves by PCG: the
    JAX package's PCG result, and one solve counted on the pcg route."""
    before = dict(pgo.CALLS)
    info = _check_against_jax(_case_arrays(_stress),
                              JPGOConfig(max_steps=25, solver="pcg"),
                              PGOConfig(max_steps=25, dense_max=16))
    assert info["solver"] == "pcg"
    assert pgo.CALLS == before | {"pcg": before["pcg"] + 1}
