// ptpu_predict: the native (C++) serving entry for exported paddle_tpu_torch
// models, without Python in the process (≙ paddle_tpu/native/
// ptpu_predict.cc; reference paddle_inference_api.h:1, api_impl.cc:126).
//
// Loads the archive io.export_inference_model wrote for the device asked
// for (__exported_native__.meta names each archive) and runs its graph
// through runtime.cc's interpreter. Two modes:
//
//   ptpu_predict <dir> <in0.npy> [...] [--out DIR] [--device cpu|cuda]
//                [--repeat N]
//     one-shot: feed .npy tensors in the meta's `in` order (checked
//     against it: dtype, rank, fixed dims), write each output as
//     out<i>.npy. --repeat runs the graph N times and prints the time of
//     each run ("run_ms [...]", the process's own timer around the run and
//     the copy of the outputs to the host).
//
//   ptpu_predict <dir> --serve [PORT] [--device cpu|cuda]
//     server: prints "LISTENING <port>" and speaks serving/transport.py's
//     protocol (u32 header length, JSON header, raw tensors), so
//     PredictorClient talks to it. Each connection gets a thread with a
//     CUDA stream of its own from the pool (≙ api_impl.cc:170 Clone), a
//     reader and a worker, so pipelined requests are answered in order;
//     an error on one request is answered with an error frame and the
//     connection keeps serving.
//
//   ptpu_predict --schemas      prints the registered ptpu:: schemas
//
// At exit the one-shot mode prints "launches {...}": each hand-written
// kernel's launches in this process.

#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <sstream>
#include <thread>

#include <ATen/ops/empty.h>

#include "runtime.h"

using ptpu::Die;

namespace {

std::string NpyDtypeName(const std::string& descr) {
  for (const char* n : {"float32", "float64", "float16", "int64", "int32",
                        "int16", "int8", "uint8", "bool"})
    if (ptpu::NpyDescr(ptpu::DtypeByName(n)) == descr) return n;
  return descr;
}

at::Tensor WireTensor(const ptpu::Json& spec, const std::string& buf) {
  std::vector<int64_t> shape;
  for (const auto& d : spec.At("shape").arr) shape.push_back(d.Int());
  at::Tensor t = at::empty(
      shape, at::TensorOptions().dtype(ptpu::DtypeByName(spec.At("dtype").str)));
  if (static_cast<size_t>(t.nbytes()) != buf.size()) Die("feed size mismatch");
  std::memcpy(t.data_ptr(), buf.data(), buf.size());
  return t;
}

std::string OutsHeader(const std::vector<std::string>& names,
                       const std::vector<const at::Tensor*>& outs) {
  std::ostringstream hj;
  hj << "{\"outs\": [";
  for (size_t i = 0; i < outs.size(); ++i) {
    if (i) hj << ", ";
    hj << "{\"name\": " << ptpu::JsonQuote(names[i]) << ", \"dtype\": "
       << ptpu::JsonQuote(ptpu::DtypeName(outs[i]->scalar_type()))
       << ", \"shape\": [";
    for (int64_t d = 0; d < outs[i]->dim(); ++d)
      hj << (d ? ", " : "") << outs[i]->size(d);
    hj << "]}";
  }
  hj << "]}";
  return hj.str();
}

struct Served {
  const ptpu::Meta& meta;
  const ptpu::Program& program;
  c10::Device device;
};

// One request: feeds by name (every declared input required), the graph,
// the optional fetch subset. Sends the response; false if the peer is gone.
bool Answer(int fd, const Served& s, const ptpu::Request& req) {
  if (!req.header.Has("feeds")) Die("request has no 'feeds'");
  const auto& feeds = req.header.At("feeds").arr;
  std::map<std::string, size_t> by_name;
  for (size_t i = 0; i < feeds.size(); ++i)
    by_name[feeds[i].At("name").str] = i;
  std::vector<at::Tensor> inputs;
  for (const auto& spec : s.meta.ins) {
    auto it = by_name.find(spec.name);
    if (it == by_name.end()) Die("missing feed '" + spec.name + "'");
    const ptpu::Json& fj = feeds[it->second];
    std::vector<int64_t> shape;
    for (const auto& d : fj.At("shape").arr) shape.push_back(d.Int());
    ptpu::CheckFeed(spec, fj.At("dtype").str, shape);
    inputs.push_back(WireTensor(fj, req.buffers[it->second]).to(s.device));
  }
  std::vector<at::Tensor> outs = s.program.Run(inputs);
  std::vector<at::Tensor> host;
  for (const auto& o : outs) host.push_back(ptpu::HostOutput(o));
  std::vector<std::string> names;
  std::vector<const at::Tensor*> selected;
  if (req.header.Has("fetch")) {
    for (const auto& want : req.header.At("fetch").arr) {
      size_t i = 0;
      while (i < s.meta.outs.size() && s.meta.outs[i].name != want.str) ++i;
      if (i == s.meta.outs.size()) Die("unknown fetch '" + want.str + "'");
      names.push_back(want.str);
      selected.push_back(&host[i]);
    }
  } else {
    for (size_t i = 0; i < host.size(); ++i) {
      names.push_back(s.meta.outs[i].name);
      selected.push_back(&host[i]);
    }
  }
  return ptpu::SendResponse(fd, OutsHeader(names, selected), selected);
}

void ServeConnection(int fd, const Served& s) {
  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::deque<ptpu::Request> queue;
  bool eof = false, worker_dead = false;
  const size_t kMaxQueued = 128;

  // the worker answers in order; the reader keeps draining the socket, so
  // a client that pipelines faster than it reads cannot deadlock the pair
  std::thread worker([&]() {
    auto stream = ptpu::UseOwnStream(s.device);
    struct Guard {
      std::mutex& mu;
      std::condition_variable& cv;
      bool& dead;
      int fd;
      ~Guard() {
        {
          std::lock_guard<std::mutex> lk(mu);
          dead = true;
        }
        cv.notify_all();
        ::shutdown(fd, SHUT_RDWR);
      }
    } guard{mu, cv_put, worker_dead, fd};
    while (true) {
      ptpu::Request req;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_get.wait(lk, [&] { return eof || !queue.empty(); });
        if (queue.empty()) return;
        req = std::move(queue.front());
        queue.pop_front();
      }
      cv_put.notify_one();
      try {
        if (!Answer(fd, s, req)) break;
      } catch (const std::exception& e) {
        if (!ptpu::SendError(fd, e.what())) break;
      }
    }
  });

  try {
    while (true) {
      ptpu::Request req;
      if (!ptpu::RecvRequest(fd, &req)) break;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_put.wait(lk, [&] { return queue.size() < kMaxQueued || worker_dead; });
        if (worker_dead) break;
        queue.push_back(std::move(req));
      }
      cv_get.notify_one();
    }
  } catch (const std::exception& e) {
    std::fprintf(stderr, "ptpu_predict: connection error: %s\n", e.what());
  }
  {
    std::lock_guard<std::mutex> lk(mu);
    eof = true;
  }
  cv_get.notify_all();
  worker.join();
  ::close(fd);
}

int ServeMain(const Served& s, int port) {
  int srv = ::socket(AF_INET, SOCK_STREAM, 0);
  if (srv < 0) Die("socket() failed");
  int one = 1;
  ::setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(srv, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0)
    Die("bind() failed");
  if (::listen(srv, 64) != 0) Die("listen() failed");
  socklen_t alen = sizeof(addr);
  ::getsockname(srv, reinterpret_cast<sockaddr*>(&addr), &alen);
  std::printf("LISTENING %d\n", ntohs(addr.sin_port));
  std::fflush(stdout);
  while (true) {
    int fd = ::accept(srv, nullptr, nullptr);
    if (fd < 0) continue;
    std::thread(ServeConnection, fd, std::cref(s)).detach();
  }
}

}  // namespace

int main(int argc, char** argv) {
  try {
    if (argc == 2 && std::strcmp(argv[1], "--schemas") == 0) {
      std::printf("%s", ptpu::RegisteredSchemas().c_str());
      return 0;
    }
    if (argc < 3) {
      std::fprintf(stderr,
                   "usage: %s <dir> <in0.npy> [...] [--out DIR] "
                   "[--device cpu|cuda] [--repeat N]\n"
                   "       %s <dir> --serve [PORT] [--device cpu|cuda]\n"
                   "       %s --schemas\n",
                   argv[0], argv[0], argv[0]);
      return 2;
    }
    std::string dir = argv[1], out_dir = ".", device_flag;
    bool serve = false;
    int port = 0, repeat = 1;
    std::vector<std::string> paths;
    for (int i = 2; i < argc; ++i) {
      if (std::strcmp(argv[i], "--out") == 0 && i + 1 < argc) {
        out_dir = argv[++i];
      } else if (std::strcmp(argv[i], "--device") == 0 && i + 1 < argc) {
        device_flag = argv[++i];
      } else if (std::strcmp(argv[i], "--repeat") == 0 && i + 1 < argc) {
        repeat = std::max(1, std::atoi(argv[++i]));
      } else if (std::strcmp(argv[i], "--serve") == 0) {
        serve = true;
        if (i + 1 < argc && std::isdigit(static_cast<unsigned char>(argv[i + 1][0])))
          port = std::atoi(argv[++i]);
      } else {
        paths.push_back(argv[i]);
      }
    }
    ptpu::Meta meta = ptpu::ReadMeta(dir + "/__exported_native__.meta");
    c10::Device device = ptpu::PickDevice(device_flag, meta);
    ptpu::ApplyTf32(meta);
    ptpu::Program program(dir + "/" + meta.archives.at(device.is_cuda() ? "cuda" : "cpu"),
                          device);
    Served served{meta, program, device};
    if (serve) return ServeMain(served, port);

    if (paths.size() != meta.ins.size())
      Die("expected " + std::to_string(meta.ins.size()) + " inputs, got " +
          std::to_string(paths.size()));
    std::vector<at::Tensor> inputs;
    for (size_t i = 0; i < paths.size(); ++i) {
      ptpu::Npy npy = ptpu::ReadNpy(paths[i]);
      if (NpyDtypeName(npy.descr) != meta.ins[i].dtype)
        Die(paths[i] + ": dtype " + npy.descr + " but model expects " +
            meta.ins[i].dtype + " (" +
            ptpu::NpyDescr(ptpu::DtypeByName(meta.ins[i].dtype)) + ")");
      ptpu::CheckFeed(meta.ins[i], meta.ins[i].dtype, npy.shape);
      inputs.push_back(
          ptpu::NpyToTensor(npy, ptpu::DtypeByName(meta.ins[i].dtype), paths[i])
              .to(device));
    }
    std::vector<at::Tensor> host;
    std::vector<double> ms;
    for (int r = 0; r < repeat; ++r) {
      ptpu::Synchronize(device);
      auto t0 = std::chrono::steady_clock::now();
      std::vector<at::Tensor> outs = program.Run(inputs);
      host.clear();
      for (const auto& o : outs) host.push_back(ptpu::HostOutput(o));
      ms.push_back(std::chrono::duration<double, std::milli>(
                       std::chrono::steady_clock::now() - t0).count());
    }
    for (size_t i = 0; i < host.size(); ++i) {
      std::string path = out_dir + "/out" + std::to_string(i) + ".npy";
      ptpu::WriteNpy(path, host[i]);
      std::printf("%s %s -> %s\n", meta.outs[i].name.c_str(),
                  ptpu::DtypeName(host[i].scalar_type()).c_str(), path.c_str());
    }
    std::printf("nodes %zu\nrun_ms [", program.num_nodes());
    for (size_t r = 0; r < ms.size(); ++r) std::printf("%s%.6f", r ? ", " : "", ms[r]);
    std::printf("]\nlaunches %s\n", ptpu::LaunchesJson().c_str());
    return 0;
  } catch (const std::exception& e) {
    std::fprintf(stderr, "ptpu_predict: %s\n", e.what());
    return 1;
  }
}
