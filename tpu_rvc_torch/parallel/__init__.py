"""Work across devices.  Conversion: B utterances as one batch (`batch`)
and one long utterance's chunks as rows (`chunks`), over a `core/mesh.py`
Mesh.  Training: several processes, one a card (`multihost`), and FSDP of
the train state over a (data, model) process mesh (`fsdp`).

The names below load their module on first use, so a training process
does not import the conversion pipeline, nor a conversion FSDP."""

import importlib

_MODULE_OF = {
    "batch_convert": "batch", "make_batch_graph": "batch",
    "convert_long": "chunks",
    "assert_state_sharded": "fsdp", "fsdp_spec": "fsdp",
    "shard_train_state": "fsdp", "train_mesh": "fsdp",
    "assert_same_across_hosts": "multihost",
    "global_batch_from_local": "multihost", "initialize": "multihost",
    "is_multiprocess": "multihost", "is_primary": "multihost"}

__all__ = list(_MODULE_OF)


def __getattr__(name):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_MODULE_OF[name]}", __name__),
                   name)
