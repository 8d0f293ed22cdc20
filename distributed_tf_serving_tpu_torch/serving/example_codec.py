"""tf.Example -> dense feature-batch decoding for the Classify/Regress/
MultiInference Input path (reference surface: input.proto:15-76 and
feature.proto:65-105 — Input carries an ExampleList or
ExampleListWithContext).

Convention: each Example carries an int64 "feat_ids" list and an optional
float "feat_wts" list, both of length num_fields (absent weights default to
1.0), mirroring the dense request contract. With ExampleListWithContext,
context features fill in whatever a per-candidate Example omits — the
two-tower pattern: user fields once in the context, item fields per
candidate.
"""

from __future__ import annotations

import numpy as np

from ..proto import serving_apis_pb2 as apis
from ..proto import tf_example_pb2 as ex


class ExampleDecodeError(ValueError):
    pass


def _merged_feature(example: ex.Example, context: ex.Example | None, key: str):
    if key in example.features.feature:
        return example.features.feature[key]
    if context is not None and key in context.features.feature:
        return context.features.feature[key]
    return None


def decode_input(inp: apis.Input, num_fields: int, arena=None) -> dict[str, np.ndarray]:
    """Decode a serving Input into the dense feat_ids/feat_wts batch.

    `arena` (codec.EncodeArena) reuses the batch's buffers across calls
    instead of allocating per request: safe because the batcher's
    prepare_inputs copies such arrays before submit() returns, and arenas
    are held per thread."""
    kind = inp.WhichOneof("kind")
    if kind == "example_list":
        examples, context = list(inp.example_list.examples), None
    elif kind == "example_list_with_context":
        examples = list(inp.example_list_with_context.examples)
        context = inp.example_list_with_context.context
    else:
        raise ExampleDecodeError("Input has neither example_list nor example_list_with_context")
    if not examples:
        raise ExampleDecodeError("Input contains no examples")

    n = len(examples)
    if arena is not None:
        ids = arena.ndarray((n, num_fields), np.int64)
        ids[:] = 0
        wts = arena.ndarray((n, num_fields), np.float32)
        wts[:] = 1.0
    else:
        ids = np.zeros((n, num_fields), np.int64)
        wts = np.ones((n, num_fields), np.float32)
    for i, example in enumerate(examples):
        f_ids = _merged_feature(example, context, "feat_ids")
        if f_ids is None or f_ids.WhichOneof("kind") != "int64_list":
            raise ExampleDecodeError(f"example {i}: missing int64 feature 'feat_ids'")
        vals = f_ids.int64_list.value
        if len(vals) != num_fields:
            raise ExampleDecodeError(
                f"example {i}: feat_ids has {len(vals)} values, model expects {num_fields}"
            )
        ids[i] = vals

        f_wts = _merged_feature(example, context, "feat_wts")
        if f_wts is not None:
            if f_wts.WhichOneof("kind") != "float_list":
                raise ExampleDecodeError(f"example {i}: feat_wts must be a float_list")
            wvals = f_wts.float_list.value
            if len(wvals) != num_fields:
                raise ExampleDecodeError(
                    f"example {i}: feat_wts has {len(wvals)} values, model expects {num_fields}"
                )
            wts[i] = wvals
    return {"feat_ids": ids, "feat_wts": wts}


def make_example(ids, wts=None) -> ex.Example:
    """Build a feat_ids/feat_wts Example (client + test helper)."""
    example = ex.Example()
    example.features.feature["feat_ids"].int64_list.value.extend(int(i) for i in ids)
    if wts is not None:
        example.features.feature["feat_wts"].float_list.value.extend(float(w) for w in wts)
    return example
