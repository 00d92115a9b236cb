"""Layouts over several devices and processes: ``mesh.py`` places the
shards and lays the trainer's (data, model) grid over the ranks,
``sharded.py`` holds the sharded index, ``multihost.py`` joins a
``torch.distributed`` group and holds its collectives, ``mh_check.py``
checks a group end to end."""
