"""Index layouts over several devices: ``mesh.py`` places the shards,
``sharded.py`` holds the sharded index."""
