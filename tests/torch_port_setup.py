"""Shared set-up of the port's parity tests: one small configuration built in
both packages, the JAX package's random parameter trees for it, and a
fixture that runs a module's torch work on one thread."""

import jax
import pytest
import torch

from jyutvoice_tpu import config as jax_config
from jyutvoice_tpu_torch import config as port_config


def small_config(cfg_module, **hift):
    """A reduced JyutVoiceConfig: 1 encoder layer, 1 transformer block per
    estimator stage and 1 mid stage, a 64-channel HiFT trunk."""
    m = cfg_module
    return m.JyutVoiceConfig(
        tts=m.TTSConfig(
            encoder=m.TextEncoderConfig(n_layers=1, filter_channels=64),
            cfm=m.CFMConfig(estimator=m.EstimatorConfig(n_blocks=1, num_mid_blocks=1)),
        ),
        hift=m.HiFTConfig(base_channels=hift.get("base_channels", 64)),
    )


JAX_CFG = small_config(jax_config)
PORT_CFG = small_config(port_config)


def jax_trees(cfg=JAX_CFG, seed=0):
    """(tts tree, hift tree) from the JAX package's own initialisers."""
    from jyutvoice_tpu.models.hift import init_hift
    from jyutvoice_tpu.models.tts import init_tts

    return (
        init_tts(jax.random.PRNGKey(seed), cfg.tts),
        init_hift(jax.random.PRNGKey(seed + 1), cfg.hift),
    )


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch on one thread for the module, restored after. Tests made of
    many small ops (training steps, a few Euler steps at small widths) run
    many times slower when the suite's parallel workers each spread every
    op over all cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
