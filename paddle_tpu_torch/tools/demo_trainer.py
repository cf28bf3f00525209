"""Train a SAVED program with no model-building code.

≙ tools/demo_trainer.py (reference paddle/fluid/train/demo/
demo_trainer.cc:55-80): load a serialized startup + main program pair,
run the startup program, then loop `Executor.run(main)` on synthesized
feeds. Training is fully described by the saved program; the driver
knows nothing about the model. It runs on `--place` (the card by
default) and prints what the JAX tool prints: one line an iteration,
then a JSON status line.

Usage:
    # save a program from any model script:
    #   ptt.io.save_program(dir, feed_names=[...], fetch_names=[loss])
    python -m paddle_tpu_torch.tools.demo_trainer --model_dir DIR \\
        --iters 10 --batch_size 8 [--place cpu]
"""

from __future__ import annotations

import argparse
import json

from . import add_place_arg, resolve_place


def synth_feed(program, feed_names, batch_size, seed=0):
    """Synthesize feed arrays from the program's declared var shapes
    (≙ the demo's fake data): the JAX tool's draws, so both tools feed a
    program the same arrays. Integer feeds are drawn from {0, 1} (a saved
    LM gets sequence lengths 0 and 1, as in the JAX tool)."""
    import numpy as np

    from ..core.dtypes import dtype_name
    rng = np.random.RandomState(seed)
    feed = {}
    blk = program.global_block()
    for name in feed_names:
        var = blk.var(name)
        shape = [batch_size if int(d) == -1 else int(d)
                 for d in (var.shape or [])]
        dname = dtype_name(var.dtype)
        if "int" in dname:
            feed[name] = rng.randint(0, 2, size=shape).astype(dname)
        else:
            feed[name] = rng.rand(*shape).astype(dname)
    return feed


def train(exe, main_prog, feed, fetch_names, iters, out=print):
    """`iters` runs of the saved main program on one feed; prints one line
    an iteration through `out` and returns the fetched values."""
    history = []
    for i in range(iters):
        vals = exe.run(main_prog, feed=feed, fetch_list=fetch_names)
        history.append(vals)
        line = " ".join(f"{n}={float(v.reshape(-1)[0]):.6f}"
                        for n, v in zip(fetch_names, vals))
        out(f"iter {i}: {line}")
    return history


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_dir", required=True)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=8)
    add_place_arg(p)
    args = p.parse_args(argv)

    import paddle_tpu_torch as ptt

    place = resolve_place(args.place)
    main_prog, startup_prog, feed_names, fetch_names = \
        ptt.io.load_program(args.model_dir)
    exe = ptt.Executor(place)
    exe.run(startup_prog)

    feed = synth_feed(main_prog, feed_names, args.batch_size)
    history = train(exe, main_prog, feed, fetch_names, args.iters)
    print(json.dumps({"status": "ok", "iters": args.iters,
                      "fetches": fetch_names}))
    return history


if __name__ == "__main__":
    main()
