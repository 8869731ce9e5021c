"""The port's export surface against the reference's, on the CPU.

Every name a package of ``mesh_tpu`` exports (its ``__all__``, or, for a
package without one, the public names its ``__init__`` binds) must resolve
in the same package of ``mesh_tpu_torch``, and so must the ``__all__`` of
``mesh_tpu.utils.dispatch`` and of the store's modules in their
counterparts, less ``LATER``: the names of modules that later items of
ROADMAP.md's Queue 1 port.  A name ported since must leave ``LATER`` (the
test fails while it is listed and resolves).
"""

import importlib
import pkgutil
import types

import pytest

import mesh_tpu

#: module -> names it exports that the port does not have yet, each with
#: the ROADMAP.md Queue 1 item that ports it
LATER = {
    # item 2: the viewer
    "mesh_tpu": {"MeshViewer", "MeshViewers"},
    # item 1: parallel/sharding.py, distributed.py, checkpoint.py
    "mesh_tpu.parallel": {
        "make_device_mesh", "shard_queries",
        "sharded_closest_faces_and_points",
        "sharded_closest_faces_sharded_topology",
        "sharded_batched_vert_normals", "sharded_batched_visibility",
        "sharded_visibility", "restore_fit_state",
        "save_fit_state", "gather_to_hosts",
        "global_device_mesh", "initialize_multihost",
        "multihost_closest_faces_and_points", "replicate_to_mesh",
        "shard_from_local"},
}

#: reference packages that later items port whole (item 2)
LATER_PACKAGES = {"mesh_tpu.analysis", "mesh_tpu.analysis.rules",
                  "mesh_tpu.viewer"}

#: modules checked besides the packages
MODULES = ("mesh_tpu.utils.dispatch", "mesh_tpu.store.store",
           "mesh_tpu.store.deltas", "mesh_tpu.store.sidecar",
           "mesh_tpu.store.blocks", "mesh_tpu.store.pages",
           "mesh_tpu.serialization.store_io")


def _packages():
    names = ["mesh_tpu"] + [
        m.name for m in pkgutil.walk_packages(mesh_tpu.__path__, "mesh_tpu.")
        if m.ispkg]
    return sorted(set(names) - LATER_PACKAGES)


def exported(module):
    """The names ``module`` exports: its ``__all__``, else the public
    names its namespace binds, less modules (a submodule is bound there
    once anything imported it, so which are depends on import order)."""
    names = getattr(module, "__all__", None)
    if names is None:
        names = [n for n, val in vars(module).items()
                 if not n.startswith("_")
                 and not isinstance(val, types.ModuleType)]
    return set(names)


@pytest.mark.parametrize("name", _packages() + list(MODULES))
def test_reference_exports_resolve_in_the_port(name):
    ref = importlib.import_module(name)
    port = importlib.import_module(name.replace("mesh_tpu", "mesh_tpu_torch",
                                                1))
    later = LATER.get(name, set())
    names = exported(ref)
    assert later <= names, "LATER lists names %s that %s does not export" % (
        sorted(later - names), name)
    missing = sorted(n for n in names - later if not hasattr(port, n))
    assert not missing, "%s lacks %s" % (port.__name__, missing)
    ported = sorted(n for n in later if hasattr(port, n))
    assert not ported, "%s has %s now: take them out of LATER" % (
        port.__name__, ported)


def test_store_all_is_the_references():
    import mesh_tpu.store as jstore

    import mesh_tpu_torch.store as tstore

    assert tstore.__all__ == jstore.__all__


def test_mesh_on_tpu_is_the_kernel_route_policy(monkeypatch):
    from mesh_tpu_torch.utils import dispatch

    class DeviceMesh(object):
        device_type = "cpu"

    monkeypatch.delenv("MESH_TPU_FORCE_XLA", raising=False)
    assert dispatch.mesh_on_tpu(DeviceMesh()) is True
    monkeypatch.setenv("MESH_TPU_FORCE_XLA", "1")
    assert dispatch.mesh_on_tpu(DeviceMesh()) is False
    DeviceMesh.device_type = "meta"
    with pytest.raises(ValueError, match="device_type"):
        dispatch.mesh_on_tpu(DeviceMesh())
