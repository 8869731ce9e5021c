"""The port's knob registry (mesh_tpu_torch/utils/knobs.py) against the
reference's: every knob the port declares has the reference's name,
kind, default and section (a path knob whose reference default is a file
under ``~/.mesh_tpu`` declares None: the port resolves its own), and the
accessors read the environment as the reference's do.
"""

import pytest

from mesh_tpu.utils import knobs as jknobs

from mesh_tpu_torch.utils import knobs as tknobs

_NAMES = [k.name for k in tknobs.declared()]

#: path knobs whose unset value the port resolves under its own folders
_OWN_PATHS = {"MESH_TPU_CACHE", "MESH_TPU_INCIDENT_DIR",
              "MESH_TPU_LOCK_WITNESS_FILE", "MESH_TPU_SERVE_STATS",
              "MESH_TPU_STORE_DIR"}


@pytest.mark.parametrize("name", _NAMES)
def test_knob_matches_reference(name):
    mine, ref = tknobs.lookup(name), jknobs.lookup(name)
    assert (mine.kind, mine.section, mine.prefix) == (
        ref.kind, ref.section, ref.prefix)
    if name in _OWN_PATHS:
        assert mine.default is None and ref.default.startswith("~/.mesh_tpu/")
    else:
        assert mine.default == ref.default
    assert mine.doc
    if not mine.prefix:
        assert tknobs.KNOBS[name] == mine.default


def test_slice_knobs_are_declared():
    for name in ("MESH_TPU_FLEET", "MESH_TPU_FLEET_SPILL",
                 "MESH_TPU_FLEET_VNODES", "MESH_TPU_LOCK_WITNESS",
                 "MESH_TPU_LOCK_WITNESS_FILE", "MESH_TPU_BENCH_FAULT",
                 "MESH_TPU_BENCH_PARTIAL"):
        assert name in _NAMES
    assert tknobs.lookup("MESH_TPU_BENCH_TIMEOUT_SERVE").name == \
        "MESH_TPU_BENCH_TIMEOUT_"


@pytest.mark.parametrize("value", [None, "", "0", "off", "No", "1", "yes",
                                   " 17 ", "2.5", "many"])
def test_accessors_read_like_the_reference(monkeypatch, value):
    names = ("MESH_TPU_FLEET", "MESH_TPU_FLEET_VNODES",
             "MESH_TPU_SERVE_DEADLINE_S", "MESH_TPU_SERVE_LADDER")
    for name in names:
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)

    def read(mod):
        return (mod.flag("MESH_TPU_FLEET"),
                mod.get_int("MESH_TPU_FLEET_VNODES"),
                mod.get_float("MESH_TPU_SERVE_DEADLINE_S"),
                mod.get_str("MESH_TPU_SERVE_LADDER"),
                mod.raw("MESH_TPU_FLEET"))

    assert read(tknobs) == read(jknobs)


def test_undeclared_knob_raises():
    for fn in (tknobs.raw, tknobs.flag, tknobs.lookup):
        with pytest.raises(KeyError, match="undeclared knob"):
            fn("MESH_TPU_NOT_A_KNOB")


def test_render_markdown_lists_every_knob():
    text = tknobs.render_markdown()
    for knob in tknobs.declared():
        assert "`%s" % knob.name in text
    assert "| `MESH_TPU_BENCH_TIMEOUT_<STAGE>` | float | unset |" in text
    assert "## Fleet" in text
