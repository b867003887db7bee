"""The parallel layer: device meshes (mesh.py) and the row-sharded feature
store (sharded_store.py) of the data-parallel serving path."""
