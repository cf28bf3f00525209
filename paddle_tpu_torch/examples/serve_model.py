"""Export a model and serve it three ways: the in-process Predictor, the
TCP PredictorServer (clone-per-connection), and the C++
`ptpu_predict --serve` speaking the same protocol.

≙ examples/serve_model.py, on the port (the card by default). The C++
server comes from the port's native build (`paddle_tpu_torch.native`,
built at first use); a failed build raises.

    python -m paddle_tpu_torch.examples.serve_model [--place cpu]
"""
import os
import subprocess
import tempfile

import numpy as np

import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers, native
from paddle_tpu_torch.examples import parse_place
from paddle_tpu_torch.inferencer import Predictor
from paddle_tpu_torch.serving import PredictorClient, PredictorServer


def main(argv=None):
    place = parse_place(argv, __doc__.splitlines()[0])
    img = layers.data("img", shape=[8, 8, 1])
    conv = layers.conv2d(img, num_filters=8, filter_size=3, padding=1,
                         data_format="NHWC", act="relu")
    flat = layers.reshape(conv, shape=[-1, 8 * 8 * 8])
    logits = layers.fc(flat, size=10, act="softmax")
    exe = ptt.Executor(place)
    exe.run(ptt.default_startup_program())

    d = os.path.join(tempfile.mkdtemp(), "model")
    ptt.io.save_inference_model(d, ["img"], [logits], executor=exe,
                                export=True, native=True)
    x = np.random.RandomState(0).rand(2, 8, 8, 1).astype("float32")

    # 1. cold-load the exported torch.export archive, no program in sight
    p = Predictor.from_exported(d, place=place)
    print("in-process:", p.run({"img": x})[0][0, :3])

    # 2. TCP server with pipelined requests
    with PredictorServer(p) as srv, \
            PredictorClient(*srv.address) as client:
        for _ in range(4):
            client.send({"img": x})
        outs = [client.recv()[0] for _ in range(4)]
        print("served (4 pipelined):", outs[0][0, :3])

    # 3. the same archive from a pure-C++ process, same wire protocol
    cuda = place.kind == "cuda"
    server = native.build(cuda=cuda)["ptpu_predict"]
    proc = subprocess.Popen([server, d, "--serve", "0", "--device",
                             "cuda" if cuda else "cpu"],
                            stdout=subprocess.PIPE, text=True)
    try:
        port = int(proc.stdout.readline().split()[1])
        with PredictorClient("127.0.0.1", port) as client:
            print("C++ server:", client.infer({"img": x})[0][0, :3])
    finally:
        proc.kill()
        proc.wait()


if __name__ == "__main__":
    main()
