"""Fleet routing identity (the part of mesh_tpu/fleet that the avatar
session pins its routing key with)."""

from .router import ROUTER_Q_LADDER, routing_key, shape_bucket  # noqa: F401
