"""Interop with TensorFlow SavedModel exports and the TF-Serving layout.

The reference's serving backend loads an externally exported SavedModel
(SURVEY.md §0: the "DCN" model with signature `serving_default`); users
migrating from TF-Serving arrive with such a directory. `savedmodel.py`
ingests it: signatures/metadata parse natively with the vendored
wire-compatible protos, variable values extract once via a TensorFlow
subprocess (the TensorBundle format needs TF; TF never enters the serving
process — its descriptor pool collides with ours), and the result lands in
the model zoo's param trees on the device, or runs through the GraphDef
executor (`graph_exec.py`). `export.py` takes a checkpoint OUT as a
SavedModel (the family's forward in plain TF ops, in a TensorFlow process
of its own) and `publish_version` / `publish_export` land an artifact in
the next version directory of a base path.
"""

__all__ = [
    "SavedModelImportError",
    "extract_variables",
    "import_savedmodel",
    "map_variables",
    "read_saved_model",
    "signatures_from_meta_graph",
]


def __getattr__(name):
    # Lazy re-exports (PEP 562): savedmodel pulls the vendored proto
    # bindings, and a process that imports TensorFlow first must still be
    # able to import this package — our tensorflow.* descriptors collide
    # with TF's in the process-wide pool, so importing the package must not
    # register them as a side effect.
    if name in __all__:
        from . import savedmodel

        return getattr(savedmodel, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
