"""The port's user examples (≙ the repo's `examples/` scripts): the same
programs, sizes and printed lines, each run as
`python -m paddle_tpu_torch.examples.<name> [--place cpu]` (on the card
by default).

- `train_mnist`: build -> train -> save -> reload -> serve one prediction;
- `generate_text`: train a tiny character LM, then greedy generation
  through the KV-cache decoder;
- `serve_model`: export a model and serve it in-process, over TCP and
  from the C++ `ptpu_predict --serve`.
"""


def parse_place(argv, description):
    """The examples' one option: `--place {cuda,cpu}` (the card by
    default; raises without one). Returns the Place."""
    import argparse

    from ..tools import add_place_arg, resolve_place
    p = argparse.ArgumentParser(description=description)
    add_place_arg(p)
    return resolve_place(p.parse_args(argv).place)
