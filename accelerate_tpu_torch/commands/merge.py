"""``accelerate-tpu-torch merge-weights`` — a checkpoint's model as
consolidated weights; the counterpart of ``accelerate_tpu/commands/merge.py``.

The JAX package restores an orbax ``model`` item on the host and exports
it. The port's ``save_state`` writes each model item as one safetensors
file of full arrays under the parameter tree's dotted keys
(``checkpointing.py``: sharded state is saved in the full layout), so
merging reads that file on the host (``utils/safetensors_io.py``) and
writes it with ``save_model``'s file names and index
(``checkpointing.export_full_weights``): ``model.safetensors``, or
``model-0000i-of-0000n.safetensors`` with ``model.safetensors.index.json``.
No device is needed. ``safe_serialization=False`` (the msgpack export)
raises, as ``save_model`` does (ROADMAP.md, Queue 1 item 6).
"""

from __future__ import annotations

import argparse
import os


def merge_command_parser(subparsers=None) -> argparse.ArgumentParser:
    description = "Merge a checkpoint's model item into safetensors files"
    if subparsers is not None:
        parser = subparsers.add_parser("merge-weights", description=description)
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch merge-weights",
                                         description=description)
    parser.add_argument("checkpoint_dir",
                        help="A save_state folder, or its model item (.../checkpoint_0/model)")
    parser.add_argument("output_path", help="Directory to write the merged weights into")
    parser.add_argument("--unsafe_serialization", action="store_true",
                        help="Write msgpack instead of safetensors (not ported: raises)")
    parser.add_argument("--max_shard_size", default="10GB", help="Split output above this size")
    if subparsers is not None:
        parser.set_defaults(func=merge_command)
    return parser


def merge_weights(checkpoint_dir: str, output_path: str, safe_serialization: bool = True,
                  max_shard_size: str = "10GB") -> None:
    """Read the model item of ``checkpoint_dir`` (a ``save_state`` folder,
    whose ``model/`` is read, or the item itself) on the host and export it
    to ``output_path``."""
    from ..checkpointing import PAYLOAD_NAME, export_full_weights
    from ..utils.constants import MODEL_NAME
    from ..utils.safetensors_io import load_file

    checkpoint_dir = os.path.abspath(checkpoint_dir)
    item = checkpoint_dir
    if not os.path.isfile(os.path.join(item, PAYLOAD_NAME)):
        item = os.path.join(checkpoint_dir, MODEL_NAME)
    payload = os.path.join(item, PAYLOAD_NAME)
    if not os.path.isfile(payload):
        raise FileNotFoundError(f"No model item at {checkpoint_dir}: neither it nor its "
                                f"{MODEL_NAME}/ holds {PAYLOAD_NAME}")
    if not safe_serialization:
        raise NotImplementedError("the msgpack export (safe_serialization=False) needs flax's "
                                  "serializer and is not ported; export safetensors "
                                  "(ROADMAP.md, Queue 1 item 6)")
    flat = load_file(payload)
    # The dotted keys in sorted order are the tree's walk (utils/tree.py).
    export_full_weights({k: flat[k] for k in sorted(flat)}, output_path,
                        max_shard_size=max_shard_size, safe_serialization=safe_serialization)
    print(f"Merged weights from {item} written to {output_path}")


def merge_command(args) -> None:
    merge_weights(args.checkpoint_dir, args.output_path,
                  safe_serialization=not args.unsafe_serialization,
                  max_shard_size=args.max_shard_size)


def main() -> None:
    merge_command(merge_command_parser().parse_args())


if __name__ == "__main__":
    main()
