"""Serving on a mesh: the sharding rules (``sharding``) and the
collectives over a mesh axis (``collectives``)."""
