"""Device meshes of the port and the lane sharding built on them."""
