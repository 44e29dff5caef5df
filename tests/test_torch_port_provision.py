"""The port's weight provisioning and export against the JAX package, on the
CPU, at the small configuration of `torch_port_setup.py` (flow encoder
64-d, 2 + 1 blocks):
  * `weights/torch_export.py`: `export_tts` of a JAX `init_tts` tree equals
    the JAX package's, key for key and bit for bit, converts back to the
    tree, and `save_torch_checkpoint` writes the same state_dict;
  * `weights/from_jax.py`: `jax_params_from_module` inverts
    `load_jax_params` bit for bit (TTS, HiFT, flow encoder) and raises on a
    parameter it would leave out or a leaf it cannot fill;
    `save_pytree_npz` writes what the JAX package's writes;
  * `weights/provision.py` and `cli/provision.py`: on the same stand-in
    flow.pt, hift.pt and tts .ckpt (the reference's key names, written by
    chip_smoke.py's writers and the JAX package's torch_export), every `.npz` equals the JAX package's bit for bit, apart
    from tts_init's random half; the strict audit and the split prefixes
    raise in both; a mocked download fills missing paths; `verify` on the
    CPU gives the JAX `verify`'s mel frames, mel MAE < 1e-2 against the JAX
    Synthesizer on the same trees;
  * `--export-torch` writes the checkpoint `save_torch_checkpoint` writes.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from jyutvoice_tpu import config as jax_config
from jyutvoice_tpu.weights import provision as jprov
from jyutvoice_tpu.weights import torch_export as jexport
from jyutvoice_tpu.weights.provision import save_pytree_npz as jax_save_pytree_npz
from jyutvoice_tpu_torch import config as port_config
from jyutvoice_tpu_torch.models.flow_encoder import FlowEncoder
from jyutvoice_tpu_torch.models.hift import HiFT
from jyutvoice_tpu_torch.models.tts import TTS
from jyutvoice_tpu_torch.weights import provision as prov
from jyutvoice_tpu_torch.weights import random_init
from jyutvoice_tpu_torch.weights import torch_convert as tc
from jyutvoice_tpu_torch.weights import torch_export as pexport
from jyutvoice_tpu_torch.weights.from_jax import (
    _flatten,
    jax_params_from_module,
    load_jax_params,
    load_pytree_npz,
    save_pytree_npz,
)
from chip_smoke import flow_encoder_state, hift_state
from torch_port_setup import JAX_CFG, PORT_CFG, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FE_KW = dict(input_size=64, output_size=64, attention_heads=2, linear_units=128,
             num_blocks=2, num_up_blocks=1)
J_CFG = dataclasses.replace(JAX_CFG, flow_encoder=jax_config.FlowEncoderConfig(**FE_KW))
P_CFG = dataclasses.replace(PORT_CFG, flow_encoder=port_config.FlowEncoderConfig(**FE_KW))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same_flat(a, b):
    assert set(a) == set(b), sorted(set(a) ^ set(b))
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def _assert_same_tree(a, b):
    _assert_same_flat(_flatten(a), _flatten(b))


@pytest.fixture(scope="module")
def trees():
    """The tts tree from the JAX package's init_tts; the HiFT and flow-encoder
    trees, of the same paths and shapes as init_hift / init_flow_encoder,
    from numpy (eager init_hift takes 16 s)."""
    from jyutvoice_tpu.models.tts import init_tts

    tt = init_tts(jax.random.PRNGKey(0), J_CFG.tts)
    th = random_init.init_hift_tree(P_CFG.hift, seed=1)
    fe = random_init.init_flow_encoder_tree(P_CFG.flow_encoder, seed=7)
    return _np(tt), th, fe


def _save_sd(path, sd):
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)


@pytest.fixture(scope="module")
def standins(trees, tmp_path_factory):
    """flow.pt (encoder half + decoder half + speaker affine), hift.pt and
    a Lightning tts .ckpt with the reference's key names."""
    tt, th, fe = trees
    d = tmp_path_factory.mktemp("standins")
    flow = flow_encoder_state(fe)
    flow.update(jexport.export_estimator(tt["decoder"], "decoder.estimator."))
    flow["spk_embed_affine_layer.weight"] = tt["spk_embed_affine_layer"]["w"].T
    flow["spk_embed_affine_layer.bias"] = tt["spk_embed_affine_layer"]["b"]
    paths = {"flow": str(d / "flow.pt"), "hift": str(d / "hift.pt"), "tts": str(d / "tts.ckpt")}
    _save_sd(paths["flow"], flow)
    _save_sd(paths["hift"], hift_state(th))
    jexport.save_torch_checkpoint(paths["tts"], tt)
    return paths, flow


# ---------------------------------------------------------------------------
# export and the inverse bridge
# ---------------------------------------------------------------------------


def test_export_tts_matches_jax_and_converts_back(trees, tmp_path):
    tt = trees[0]
    got, want = pexport.export_tts(tt), jexport.export_tts(tt)
    _assert_same_flat(got, want)
    _assert_same_tree(tc.convert_tts(got, P_CFG.tts), tt)
    p, j = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    pexport.save_torch_checkpoint(p, tt)
    jexport.save_torch_checkpoint(j, tt)
    _assert_same_flat(tc.load_torch_state_dict(p), tc.load_torch_state_dict(j))
    assert set(torch.load(p, weights_only=False)) == {"state_dict"}


@pytest.mark.parametrize("kind", ["tts", "hift", "flow_encoder"])
def test_module_to_tree_inverts_the_bridge(trees, kind):
    tree = dict(zip(("tts", "hift", "flow_encoder"), trees))[kind]
    make = {"tts": lambda: TTS(P_CFG.tts), "hift": lambda: HiFT(P_CFG.hift),
            "flow_encoder": lambda: FlowEncoder(P_CFG.flow_encoder)}[kind]
    module = load_jax_params(make(), tree)
    back = jax_params_from_module(module)
    _assert_same_tree(back, tree)
    # and it loads again into a fresh module, parameters bit-equal
    again = load_jax_params(make(), back)
    for (n, a), (_, b) in zip(module.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), n


def test_module_to_tree_is_strict(trees):
    module = load_jax_params(TTS(P_CFG.tts), trees[0])
    # a parameter no tree leaf would hold
    module.spk_embed_affine_layer.register_parameter("extra", torch.nn.Parameter(torch.ones(3)))
    with pytest.raises(ValueError, match="left out of the tree"):
        jax_params_from_module(module)
    del module.spk_embed_affine_layer.extra
    jax_params_from_module(module)
    # a leaf module without its weight
    module.decoder.final_proj.weight = None
    with pytest.raises(ValueError, match="has no weight"):
        jax_params_from_module(module)


def test_save_pytree_npz_matches_jax(trees, tmp_path):
    tt = trees[0]
    p, j = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_pytree_npz(p, tt)
    jax_save_pytree_npz(j, tt)
    with np.load(p) as a, np.load(j) as b:
        _assert_same_flat({k: a[k] for k in a.files}, {k: b[k] for k in b.files})
    _assert_same_tree(jprov.load_pytree_npz(p), tt)
    _assert_same_tree(load_pytree_npz(j), tt)


# ---------------------------------------------------------------------------
# provisioning
# ---------------------------------------------------------------------------


def _npz(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def test_provision_matches_jax(standins, tmp_path):
    paths, _ = standins
    kw = dict(flow_pt=paths["flow"], hift_pt=paths["hift"], tts_ckpt=paths["tts"],
              assemble_pretrain=True, seed=5)
    got = prov.provision(out_dir=str(tmp_path / "port"), cfg=P_CFG, **kw)
    want = jprov.provision(out_dir=str(tmp_path / "jax"), cfg=J_CFG, **kw)
    assert set(got) == set(want) == {"flow_encoder", "flow_decoder", "tts_init", "hift", "tts"}
    for name in ("flow_encoder", "flow_decoder", "hift", "tts"):
        _assert_same_flat(_npz(got[name]), _npz(want[name]))
    # tts_init: the decoder and the speaker affine are the JAX package's
    # leaves; the random half is this package's init_tts_tree(seed)
    mine, theirs = _npz(got["tts_init"]), _npz(want["tts_init"])
    assert set(mine) == set(theirs)
    frozen = [k for k in mine if k.startswith(("decoder/", "spk_embed_affine_layer/"))]
    _assert_same_flat({k: mine[k] for k in frozen}, {k: theirs[k] for k in frozen})
    rand = _flatten(random_init.init_tts_tree(P_CFG.tts, seed=5))
    _assert_same_flat({k: v for k, v in mine.items() if k not in frozen},
                      {k: v for k, v in rand.items() if k not in frozen})
    # the assembled tree loads into the port's model
    load_jax_params(TTS(P_CFG.tts), load_pytree_npz(got["tts_init"]))


def test_provision_strict_audit_raises_in_both(standins, tmp_path):
    from jyutvoice_tpu.weights.audit import ConversionAuditError as JaxAuditError
    from jyutvoice_tpu_torch.weights.audit import ConversionAuditError

    _, flow = standins
    extra = str(tmp_path / "extra.pt")
    _save_sd(extra, {**flow, "decoder.estimator.extra.weight": np.zeros(3, np.float32)})
    with pytest.raises(ConversionAuditError, match="never consumed"):
        prov.provision(flow_pt=extra, out_dir=str(tmp_path / "p"), cfg=P_CFG)
    with pytest.raises(JaxAuditError, match="never consumed"):
        jprov.provision(flow_pt=extra, out_dir=str(tmp_path / "j"), cfg=J_CFG)
    outside = str(tmp_path / "outside.pt")
    _save_sd(outside, {**flow, "postnet.weight": np.zeros(3, np.float32)})
    for fn, cfg in ((prov.provision, P_CFG), (jprov.provision, J_CFG)):
        with pytest.raises(ValueError, match="outside the reference's split"):
            fn(flow_pt=outside, out_dir=str(tmp_path / "o"), cfg=cfg)
    with pytest.raises(ValueError, match="requires flow_pt"):
        prov.provision(out_dir=str(tmp_path / "n"), cfg=P_CFG, assemble_pretrain=True)


def test_download_fills_missing_paths(standins, tmp_path):
    """A fake fetch serves flow.pt and hift.pt and fails the rest (offline):
    the provisioned trees are those of the explicit paths; nothing half
    written stays behind."""
    import shutil

    paths, _ = standins
    served = {"flow.pt": paths["flow"], "hift.pt": paths["hift"]}
    fetched = []

    def fetch(url, dest):
        name = url.rsplit("/", 1)[-1]
        fetched.append(name)
        if name not in served:
            with open(dest, "wb") as f:
                f.write(b"partial")
            raise OSError("offline")
        shutil.copy(served[name], dest)

    dl = tmp_path / "dl"
    got = prov.provision(out_dir=str(tmp_path / "npz"), cfg=P_CFG, download=True,
                         download_dir=str(dl), fetch=fetch, assemble_pretrain=True)
    assert sorted(fetched) == sorted(prov.ARTIFACT_URLS)
    assert sorted(os.listdir(dl)) == ["flow.pt", "hift.pt"]
    direct = prov.provision(flow_pt=paths["flow"], hift_pt=paths["hift"],
                            out_dir=str(tmp_path / "direct"), cfg=P_CFG)
    for name in ("flow_encoder", "flow_decoder", "hift"):
        _assert_same_flat(_npz(got[name]), _npz(direct[name]))
    assert "tts_init" in got
    # present files are not fetched again
    fetched.clear()
    out = prov.download_artifacts(str(dl), fetch=fetch)
    assert out["flow.pt"] == str(dl / "flow.pt") and "flow.pt" not in fetched


def test_verify_matches_jax(standins, trees, tmp_path, capsys):
    """`verify` on the CPU from the same stand-ins: the JAX verify's mel
    frames, and a mel within 1e-2 (MAE) of the JAX Synthesizer's on the
    trees the JAX package provisioned."""
    import json

    from jyutvoice_tpu.pipeline.synthesize import Synthesizer as JaxSynthesizer

    paths, _ = standins
    kw = dict(flow_pt=paths["flow"], hift_pt=paths["hift"], tts_ckpt=paths["tts"], text="佢",
              lang="yue", phone="keoi5", n_timesteps=2)
    want = jprov.verify(out_dir=str(tmp_path / "jax"), cfg=J_CFG, **kw)
    jsyn = JaxSynthesizer(J_CFG, jprov.load_pytree_npz(str(tmp_path / "jax" / "tts.npz")),
                          jprov.load_pytree_npz(str(tmp_path / "jax" / "hift.npz")))
    ref = jsyn.synthesize("佢", lang="yue", phone="keoi5", n_timesteps=2).mel
    np.save(str(tmp_path / "ref_mel.npy"), ref)
    capsys.readouterr()
    got = prov.verify(out_dir=str(tmp_path / "port"), cfg=P_CFG, device="cpu",
                      reference_mel=str(tmp_path / "ref_mel.npy"), **kw)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(got))
    assert got["mel_frames"] == want["mel_frames"] == len(ref)
    assert got["mel_mae"] < 1e-2 and got["mel_mae_pass"]
    assert got["audit"].startswith("pass") and got["xrt"] > 0


def test_cli_provision_and_export_torch(standins, trees, tmp_path):
    from jyutvoice_tpu_torch.cli import provision as cli

    paths, _ = standins
    out = str(tmp_path / "npz")
    written = cli.main(["--flow-pt", paths["flow"], "--hift-pt", paths["hift"],
                        "--assemble-pretrain", "--seed", "3", "--out-dir", out], cfg=P_CFG)
    assert set(written) == {"flow_encoder", "flow_decoder", "tts_init", "hift"}
    init = load_pytree_npz(written["tts_init"])
    _assert_same_tree(init["decoder"], trees[0]["decoder"])
    ckpt = str(tmp_path / "tts.ckpt")
    assert cli.main(["--export-torch", written["tts_init"], ckpt]) == {"torch_ckpt": ckpt}
    _assert_same_flat(tc.load_torch_state_dict(ckpt), pexport.export_tts(init))
    with pytest.raises(SystemExit):
        cli.main(["--export-torch", written["tts_init"]])


def test_standin_writers_invert_the_converters(trees):
    """chip_smoke.py's JAX-free writers of flow.pt's encoder half and of
    hift.pt (the stand-ins of these tests) convert back to their trees."""
    _, th, fe = trees
    _assert_same_tree(tc.convert_flow_encoder(flow_encoder_state(fe), P_CFG.flow_encoder), fe)
    _assert_same_tree(tc.convert_hift(hift_state(th), P_CFG.hift), th)
