// ptpu_train: the native (C++) training entry, K train steps without
// Python in the process (≙ paddle_tpu/native/ptpu_train.cc; reference
// train/demo/demo_trainer.cc:55-80).
//
// Loads the one-step archive io.export_train_program wrote
// (__exported_train__.pt2, __exported_train__.meta and the
// train_state_<i>.npy starting values) and runs it K times:
//
//   ptpu_train <dir> <in0.npy> [...] --steps K [--out DIR]
//              [--device cpu|cuda]
//
// The .npy files are the feeds in the meta's `in` order after __seed__
// (one fixed batch, fed every step, as the demo trainer's). Each step
// seeds the process's generators with its index (the meta's __seed__,
// which is no graph input), runs the graph on (feeds, state) and feeds
// the updated state back by the meta's `carry` lines. It prints
// "step <i> <loss name> <value>" per loss and step, the carried state as
// state<in index>.npy in --out, each step's time ("step_ms [...]", its
// own timer around the step, the losses read back included) and the
// kernels' launches ("launches {...}").

#include <ATen/Context.h>

#include <chrono>
#include <cstdio>
#include <cstring>

#include "runtime.h"

using ptpu::Die;

int main(int argc, char** argv) {
  try {
    if (argc < 2) {
      std::fprintf(stderr,
                   "usage: %s <dir> <in0.npy> [...] --steps K [--out DIR] "
                   "[--device cpu|cuda]\n",
                   argv[0]);
      return 2;
    }
    std::string dir = argv[1], out_dir = ".", device_flag;
    int steps = 1;
    std::vector<std::string> paths;
    for (int i = 2; i < argc; ++i) {
      if (std::strcmp(argv[i], "--steps") == 0 && i + 1 < argc) {
        steps = std::atoi(argv[++i]);
      } else if (std::strcmp(argv[i], "--out") == 0 && i + 1 < argc) {
        out_dir = argv[++i];
      } else if (std::strcmp(argv[i], "--device") == 0 && i + 1 < argc) {
        device_flag = argv[++i];
      } else {
        paths.push_back(argv[i]);
      }
    }
    ptpu::Meta meta = ptpu::ReadMeta(dir + "/__exported_train__.meta");
    if (meta.ins.empty() || meta.ins[0].name != "__seed__")
      Die("the train meta's first input must be __seed__");
    c10::Device device = ptpu::PickDevice(device_flag, meta);
    ptpu::ApplyTf32(meta);
    ptpu::Program program(
        dir + "/" + meta.archives.at(device.is_cuda() ? "cuda" : "cpu"), device);

    // graph input j is meta input j + 1 (after __seed__): the feeds, then
    // the state from its init file
    std::vector<at::Tensor> inputs(meta.ins.size() - 1);
    size_t next_path = 0;
    for (size_t i = 1; i < meta.ins.size(); ++i) {
      const ptpu::TensorSpec& spec = meta.ins[i];
      at::ScalarType dtype = ptpu::DtypeByName(spec.dtype);
      auto init = meta.init.find(static_cast<int>(i));
      std::string path;
      if (init != meta.init.end()) {
        path = dir + "/" + init->second;
      } else {
        if (next_path >= paths.size())
          Die("missing feed '" + spec.name + "': give one .npy per feed");
        path = paths[next_path++];
      }
      ptpu::Npy npy = ptpu::ReadNpy(path);
      ptpu::CheckFeed(spec, spec.dtype, npy.shape);
      inputs[i - 1] = ptpu::NpyToTensor(npy, dtype, path).to(device);
    }
    if (next_path != paths.size())
      Die("expected " + std::to_string(next_path) + " feeds, got " +
          std::to_string(paths.size()));
    if (program.num_user_inputs() != inputs.size())
      Die("the archive takes " + std::to_string(program.num_user_inputs()) +
          " inputs, the meta names " + std::to_string(inputs.size()));

    std::vector<double> ms;
    for (int step = 0; step < steps; ++step) {
      ptpu::Synchronize(device);
      auto t0 = std::chrono::steady_clock::now();
      at::manual_seed(static_cast<uint64_t>(step));  // the step's __seed__
      std::vector<at::Tensor> outs = program.Run(inputs);
      std::vector<double> losses;
      for (int i = 0; i < meta.nfetch; ++i)
        losses.push_back(outs[i].reshape({-1})[0].item<double>());
      ms.push_back(std::chrono::duration<double, std::milli>(
                       std::chrono::steady_clock::now() - t0).count());
      for (int i = 0; i < meta.nfetch; ++i)
        std::printf("step %d %s %.8f\n", step, meta.outs[i].name.c_str(),
                    losses[i]);
      for (const auto& [out_idx, in_idx] : meta.carry)
        inputs[in_idx - 1] = outs.at(out_idx);
    }
    for (const auto& [out_idx, in_idx] : meta.carry) {
      std::string path = out_dir + "/state" + std::to_string(in_idx) + ".npy";
      ptpu::WriteNpy(path, inputs[in_idx - 1]);
      std::printf("state %s -> %s\n", meta.ins[in_idx].name.c_str(),
                  path.c_str());
    }
    std::printf("nodes %zu\nstep_ms [", program.num_nodes());
    for (size_t i = 0; i < ms.size(); ++i)
      std::printf("%s%.6f", i ? ", " : "", ms[i]);
    std::printf("]\nlaunches %s\n", ptpu::LaunchesJson().c_str());
    return 0;
  } catch (const std::exception& e) {
    std::fprintf(stderr, "ptpu_train: %s\n", e.what());
    return 1;
  }
}
