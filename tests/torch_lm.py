"""Shared inputs for the language-model parity tests: the reference's
configs and params, carried into the port through ``params_from_numpy``."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import model as RM
from repro.models.layers import split_params as ref_split
from repro_torch.configs import get_config, reduced
from repro_torch.models.convert import params_from_numpy


def twin_configs(arch, **over):
    """(reference config, port config): ``reduced`` of ``arch`` with ``over``."""
    ref = dataclasses.replace(ref_reduced(ref_get_config(arch)), **over)
    port = dataclasses.replace(reduced(get_config(arch)), **over)
    return ref, port


def twin_params(ref_cfg, seed=0):
    """(reference value tree, the same values as the port's tree on the CPU)."""
    pv = ref_split(RM.init_params(ref_cfg, jax.random.key(seed)))[0]
    return pv, params_from_numpy(jax.tree.map(np.asarray, pv), "cpu")


def twin_batch(cfg, rng, b=2, s=32):
    """(reference batch, port batch) of tokens and the frontend stub."""
    arrays = dict(tokens=rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))
    if cfg.frontend == "vlm":
        arrays["frontend"] = rng.normal(size=(b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        arrays["frontend"] = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return (
        {k: jnp.asarray(v) for k, v in arrays.items()},
        {k: torch.as_tensor(v) for k, v in arrays.items()},
    )


def f32(x) -> np.ndarray:
    """A JAX array or a torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread for the module that imports this fixture.
    The suite runs several workers on the machine's cores, and a default
    thread team in each oversubscribes them: a training loop of small ops
    then waits on every op's team (the training files ran 7-35x slower
    than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
