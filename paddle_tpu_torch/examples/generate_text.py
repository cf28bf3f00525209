"""Train a tiny character LM and generate from it with the KV-cache
decoder: the full train -> generate loop in one file.

≙ examples/generate_text.py, on the port (the card by default; training
runs the flash-attention kernels, generation the decode-attention
kernel):

    python -m paddle_tpu_torch.examples.generate_text [--place cpu]
"""

import numpy as np

import paddle_tpu_torch as ptt
from paddle_tpu_torch.examples import parse_place
from paddle_tpu_torch.framework.program import program_guard
from paddle_tpu_torch.models import transformer

TEXT = ("the quick brown fox jumps over the lazy dog and the dog barks "
        "at the quick brown fox while the lazy dog sleeps ") * 40
CHARS = sorted(set(TEXT))
V, T, D = len(CHARS) + 1, 32, 64           # +1 for BOS at id 0
ENC = {c: i + 1 for i, c in enumerate(CHARS)}
DEC = {i + 1: c for i, c in enumerate(CHARS)}
#: training steps
STEPS = 300


def batches(rng, b=32):
    ids = np.array([ENC[c] for c in TEXT], "int64")
    while True:
        starts = rng.randint(0, len(ids) - T - 1, (b,))
        toks = np.stack([ids[s:s + T] for s in starts])
        tgts = np.stack([ids[s + 1:s + T + 1] for s in starts])
        yield {"tokens": toks, "tokens@SEQLEN": np.full((b,), T, "int32"),
               "targets": tgts}


def main(argv=None):
    place = parse_place(argv, __doc__.splitlines()[0])
    rng = np.random.RandomState(0)
    loss, _ = transformer.transformer_lm(
        vocab=V, max_len=T, d_model=D, d_inner=128, num_heads=4,
        num_layers=2, dropout=0.0)
    ptt.optimizer.AdamOptimizer(learning_rate=3e-3).minimize(loss)
    exe = ptt.Executor(place)
    exe.run(ptt.default_startup_program())

    it = batches(rng)
    for step in range(STEPS):
        l = exe.run(feed=next(it), fetch_list=[loss])[0]
        if step % 100 == 0:
            print(f"step {step}: loss {float(l):.3f}")

    gen_prog = ptt.Program()
    with program_guard(gen_prog, ptt.Program()), ptt.unique_name.guard():
        seqs, scores = transformer.transformer_lm_generate(
            vocab=V, max_gen=48, d_model=D, d_inner=128, num_heads=4,
            num_layers=2, bos_id=ENC["t"], beam_size=1)
    out = exe.run(program=gen_prog,
                  feed={"prompt": np.full((1, 1), ENC["t"], "int64")},
                  fetch_list=[seqs])[0]
    text = "t" + "".join(DEC.get(int(i), "?") for i in out[0, :, 0])
    print("generated:", repr(text))


if __name__ == "__main__":
    main()
