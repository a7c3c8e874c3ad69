"""The port's option table against the JAX package's: every option has
the same name, type, default, level, bounds, enum values, see-also and
startup flag, in the same order, and the same help text, but for the
port's one change of meaning (``ec_backend`` offers ``torch`` where the
reference offers ``jax``, and defaults to it, so an OSD builds its pools'
codecs on the card unless asked for the host) and the help texts that named the jax backend
and the jit (``ec_batch``, ``ec_kernel``, ``osd_scrub_fold``), which name
the torch backend and the card, and ``ec_shard``'s, which names the
port's fan-out (logical devices, CUDA kernels on streams) in place of
XLA's."""

import dataclasses

import pytest

import ceph_tpu.utils.config as ref_config
import ceph_tpu_torch.utils.config as port_config

REF = {o.name: o for o in ref_config.OPTIONS}
PORT = {o.name: o for o in port_config.OPTIONS}
#: the options whose help text the port rewrote
REWORDED = ("ec_batch", "ec_kernel", "osd_scrub_fold")
#: ... and the fan-out's, which named XLA's devices
REWORDED_FANOUT = ("ec_shard",)


def fields(option, skip=()) -> dict:
    out = {f.name: getattr(option, f.name)
           for f in dataclasses.fields(option) if f.name not in skip}
    if "level" in out:
        out["level"] = out["level"].value
    return out


def test_same_options_in_the_same_order():
    assert list(PORT) == list(REF)
    assert len(PORT) == len(port_config.OPTIONS)


@pytest.mark.parametrize("name", sorted(REF))
def test_option_matches_the_reference(name):
    ref, port = REF[name], PORT[name]
    skip = ("desc",) if name in REWORDED + REWORDED_FANOUT else ()
    if name == "ec_backend":
        skip += ("enum_values", "default")
    assert fields(port, skip) == fields(ref, skip)


def test_ec_backend_offers_torch_in_place_of_jax():
    assert REF["ec_backend"].enum_values == ("auto", "native", "numpy",
                                             "jax")
    assert PORT["ec_backend"].enum_values == ("auto", "native", "numpy",
                                              "torch")
    assert REF["ec_backend"].default == "auto"
    assert PORT["ec_backend"].default == "torch"
    cfg = port_config.default_config()
    cfg.apply_dict({"ec_backend": "torch"})
    assert cfg["ec_backend"] == "torch"
    with pytest.raises(port_config.ConfigError):
        cfg.apply_dict({"ec_backend": "jax"})


@pytest.mark.parametrize("name", REWORDED)
def test_reworded_help_names_the_torch_backend(name):
    assert "jax" in REF[name].desc or "jit" in REF[name].desc
    desc = PORT[name].desc
    assert "jax" not in desc and "jit" not in desc
    assert "torch" in desc or "card" in desc


def test_ec_shard_help_names_the_ports_fan_out():
    assert "XLA" in REF["ec_shard"].desc
    desc = PORT["ec_shard"].desc
    assert "XLA" not in desc
    assert "CUDA kernel" in desc and "force_devices" in desc


def test_no_other_help_text_names_jax():
    assert [n for n, o in PORT.items() if "jax" in o.desc.lower()] == []


def test_defaults_validate_and_dump():
    cfg = port_config.default_config()
    for name, opt in PORT.items():
        assert cfg[name] == opt.default
