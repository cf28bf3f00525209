"""Train an MNIST classifier end to end: build -> train -> evaluate ->
save -> reload -> serve one prediction.

≙ examples/train_mnist.py, on the port (the card by default):

    python -m paddle_tpu_torch.examples.train_mnist [--place cpu]

Uses the port's synthetic MNIST digits (`data.datasets.mnist`; the port
downloads nothing).
"""
import os
import tempfile

import numpy as np

import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers
from paddle_tpu_torch.data import datasets
from paddle_tpu_torch.examples import parse_place

#: the demo slice: training stops after this many samples
SAMPLES = 12800


def main(argv=None):
    place = parse_place(argv, __doc__.splitlines()[0])
    img = layers.data("img", shape=[784])
    label = layers.data("label", shape=[1], dtype="int64")
    h = layers.fc(img, size=200, act="relu")
    h = layers.fc(h, size=200, act="relu")
    logits = layers.fc(h, size=10)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(logits, label)
    ptt.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(loss)

    exe = ptt.Executor(place)
    exe.run(ptt.default_startup_program())

    train = datasets.mnist.train()
    batch, bs = [], 64
    for epoch in range(1):
        for i, (x, y) in enumerate(train()):
            batch.append((x, y))
            if len(batch) < bs:
                continue
            xs = np.stack([b[0] for b in batch]).reshape(bs, 784)
            ys = np.array([b[1] for b in batch], "int64").reshape(bs, 1)
            batch = []
            l, a = exe.run(feed={"img": xs.astype("float32"), "label": ys},
                           fetch_list=[loss, acc])
            if i % 6400 < bs:
                print(f"epoch {epoch} step {i // bs}: "
                      f"loss {float(l):.3f} acc {float(a):.3f}")
            if i >= SAMPLES:                # a quick demo slice
                break

    d = os.path.join(tempfile.mkdtemp(), "mnist_model")
    ptt.io.save_inference_model(d, ["img"], [logits], executor=exe)
    pred = ptt.Predictor(d, place=place)
    probe = np.random.RandomState(0).rand(1, 784).astype("float32")
    print("reloaded predictor says:",
          int(np.argmax(pred.run({"img": probe})[0])))


if __name__ == "__main__":
    main()
