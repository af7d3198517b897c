// The native serving runner: load an AOTInductor package of the port's
// serving graph (python -m ayolov2_torch.cli.export ... --aoti writes
// {name}.aoti.pt2) and serve uint8 batches with it, without Python.
//
// The counterpart of the JAX package's cpp/src/pjrt_runner/main.cpp, with
// its flags and output lines:
//
//   aoti_runner --program best_tpu_nms.aoti.pt2 [--device cuda|cpu]
//       [--batch 32] [--height 640] [--width 640] [--iters 137] [--warmup 3]
//       [--input raw.bin] [--dump-output prefix]
//       [--sidecar best_tpu_nms.yaml] [--op-library early_pipeline_op.so]
//
// --device takes the place of --plugin (cuda, the default, exits non-zero
// where CUDA is absent; nothing falls back to the CPU); --compile-options and
// --opt have no meaning here: the package is compiled already. --input is a
// raw uint8 NHWC batch (else every byte 114); --dump-output writes one
// verification call's outputs as <prefix>.outN.bin, dense row-major. The
// batch is put on the device once; each timed call runs the package on it
// and leaves its outputs there, and the card is synchronised before the clock
// is read. On the CPU, OMP_NUM_THREADS sets ATen's intra-op threads.
//
// Before loading the package the runner opens the library that registers the
// operator ayolov2::early_pipeline (csrc/early_pipeline_op.cpp; the path this
// runner was built with, or --op-library) and passes it, for each early-network
// call the sidecar ({name}.yaml beside {name}.aoti.pt2, or --sidecar) lists,
// the kernel's library and plan. At the end it prints the kernel's launches
// as that registration counted them.

#include <ATen/ops/from_blob.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/cuda.h>

#include <dlfcn.h>

#include <cctype>
#include <chrono>
#include <cstdint>
#include <fstream>
#include <iostream>
#include <sstream>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

#ifndef AYOLOV2_OP_LIBRARY
#define AYOLOV2_OP_LIBRARY ""
#endif

namespace {

struct Options {
  std::string program;
  std::string device = "cuda";
  int64_t batch = 32;
  int64_t height = 640;
  int64_t width = 640;
  int iters = 137;  // the reference's torchscript_runner benchmark length
  int warmup = 3;
  std::string input;        // raw uint8 NHWC input file (else fill 114)
  std::string dump_output;  // prefix: write <prefix>.outN.bin per output
  std::string sidecar;
  std::string op_library = AYOLOV2_OP_LIBRARY;
};

// ---- a small JSON reader, enough for the sidecar ------------------------------

struct Json {
  enum Kind { kNull, kBool, kNum, kStr, kArr, kObj } kind = kNull;
  bool boolean = false;
  double num = 0;
  std::string str;
  std::vector<Json> arr;
  std::vector<std::pair<std::string, Json>> obj;

  const Json* get(const std::string& key) const {
    for (const auto& kv : obj)
      if (kv.first == key) return &kv.second;
    return nullptr;
  }
};

class JsonReader {
 public:
  explicit JsonReader(const std::string& text) : s_(text) {}

  Json read() {
    Json v = value();
    space();
    if (i_ != s_.size()) fail("trailing characters");
    return v;
  }

 private:
  const std::string& s_;
  size_t i_ = 0;

  [[noreturn]] void fail(const std::string& what) {
    throw std::runtime_error("sidecar JSON: " + what + " at byte " + std::to_string(i_));
  }
  void space() {
    while (i_ < s_.size() && std::isspace(static_cast<unsigned char>(s_[i_]))) ++i_;
  }
  bool take(char c) {
    space();
    if (i_ < s_.size() && s_[i_] == c) {
      ++i_;
      return true;
    }
    return false;
  }
  void expect(char c) {
    if (!take(c)) fail(std::string("expected '") + c + "'");
  }
  std::string string() {
    expect('"');
    std::string out;
    while (i_ < s_.size() && s_[i_] != '"') {
      char c = s_[i_++];
      if (c == '\\') {
        if (i_ >= s_.size()) fail("cut escape");
        char e = s_[i_++];
        switch (e) {
          case 'n': out += '\n'; break;
          case 't': out += '\t'; break;
          case 'r': out += '\r'; break;
          case 'b': out += '\b'; break;
          case 'f': out += '\f'; break;
          case 'u': {
            if (i_ + 4 > s_.size()) fail("cut \\u escape");
            unsigned code = std::stoul(s_.substr(i_, 4), nullptr, 16);
            i_ += 4;
            if (code < 0x80) {
              out += static_cast<char>(code);
            } else if (code < 0x800) {
              out += static_cast<char>(0xC0 | (code >> 6));
              out += static_cast<char>(0x80 | (code & 0x3F));
            } else {
              out += static_cast<char>(0xE0 | (code >> 12));
              out += static_cast<char>(0x80 | ((code >> 6) & 0x3F));
              out += static_cast<char>(0x80 | (code & 0x3F));
            }
            break;
          }
          default: out += e;
        }
      } else {
        out += c;
      }
    }
    expect('"');
    return out;
  }
  Json value() {
    space();
    if (i_ >= s_.size()) fail("unexpected end");
    Json v;
    char c = s_[i_];
    if (c == '{') {
      v.kind = Json::kObj;
      ++i_;
      if (take('}')) return v;
      do {
        space();
        std::string key = string();
        expect(':');
        v.obj.emplace_back(key, value());
      } while (take(','));
      expect('}');
    } else if (c == '[') {
      v.kind = Json::kArr;
      ++i_;
      if (take(']')) return v;
      do v.arr.push_back(value());
      while (take(','));
      expect(']');
    } else if (c == '"') {
      v.kind = Json::kStr;
      v.str = string();
    } else if (s_.compare(i_, 4, "true") == 0 || s_.compare(i_, 5, "false") == 0) {
      v.kind = Json::kBool;
      v.boolean = s_[i_] == 't';
      i_ += v.boolean ? 4 : 5;
    } else if (s_.compare(i_, 4, "null") == 0) {
      i_ += 4;
    } else {
      size_t used = 0;
      v.kind = Json::kNum;
      v.num = std::stod(s_.substr(i_, 32), &used);
      if (used == 0) fail("bad value");
      i_ += used;
    }
    return v;
  }
};

std::string read_file(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot open " + path);
  std::ostringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

// {name}.aoti.pt2 -> {name}.yaml
std::string sidecar_of(const std::string& program) {
  const std::string suffix = ".aoti.pt2";
  if (program.size() > suffix.size() &&
      program.compare(program.size() - suffix.size(), suffix.size(), suffix) == 0)
    return program.substr(0, program.size() - suffix.size()) + ".yaml";
  return program + ".yaml";
}

// ---- the operator's registration ------------------------------------------------

struct OpLibrary {
  int (*configure)(const char*, const int64_t*, const int*) = nullptr;
  const char* (*error)() = nullptr;
  int64_t (*launches)() = nullptr;
};

template <typename T>
void symbol(void* handle, const char* name, T* out) {
  *out = reinterpret_cast<T>(dlsym(handle, name));
  if (!*out) throw std::runtime_error(std::string("operator library lacks ") + name);
}

OpLibrary open_op_library(const std::string& path) {
  if (path.empty())
    throw std::runtime_error("no operator library: build the runner through "
                             "ayolov2_torch.ops._build or pass --op-library");
  // global, so that the registration's symbols serve the package's proxy calls
  void* handle = dlopen(path.c_str(), RTLD_NOW | RTLD_GLOBAL);
  if (!handle) throw std::runtime_error("cannot load " + path + ": " + dlerror());
  OpLibrary lib;
  symbol(handle, "ayolov2_early_pipeline_configure", &lib.configure);
  symbol(handle, "ayolov2_early_pipeline_error", &lib.error);
  symbol(handle, "ayolov2_early_pipeline_launches", &lib.launches);
  return lib;
}

// Pass each early-network call's kernel library and plan to the registration;
// returns the sidecar's output count (0 where it lists none).
size_t configure(const Json& sidecar, const OpLibrary& lib) {
  const Json* aoti = sidecar.get("aoti");
  const Json* calls = aoti ? aoti->get("early_pipeline") : nullptr;
  for (const Json& call : calls ? calls->arr : std::vector<Json>{}) {
    const Json* library = call.get("library");
    const Json* widths = call.get("widths");
    const Json* plan = call.get("plan");
    if (!library || library->kind != Json::kStr) continue;  // a CPU package: no kernel
    if (!widths || widths->arr.size() != 5 || !plan || plan->arr.size() != 14)
      throw std::runtime_error("sidecar: an early_pipeline entry needs 5 widths and 14 plan ints");
    int64_t w[5];
    int p[14];
    for (int i = 0; i < 5; ++i) w[i] = static_cast<int64_t>(widths->arr[i].num);
    for (int i = 0; i < 14; ++i) p[i] = static_cast<int>(plan->arr[i].num);
    if (lib.configure(library->str.c_str(), w, p) != 0) throw std::runtime_error(lib.error());
  }
  const Json* outputs = sidecar.get("outputs");
  return outputs ? outputs->arr.size() : 0;
}

bool parse_args(int argc, char** argv, Options* opt) {
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    if (i + 1 >= argc) {
      std::cerr << "missing value for " << a << "\n";
      return false;
    }
    std::string v = argv[++i];
    if (a == "--program") opt->program = v;
    else if (a == "--device") opt->device = v;
    else if (a == "--batch") opt->batch = std::stol(v);
    else if (a == "--height") opt->height = std::stol(v);
    else if (a == "--width") opt->width = std::stol(v);
    else if (a == "--iters") opt->iters = std::stoi(v);
    else if (a == "--warmup") opt->warmup = std::stoi(v);
    else if (a == "--input") opt->input = v;
    else if (a == "--dump-output") opt->dump_output = v;
    else if (a == "--sidecar") opt->sidecar = v;
    else if (a == "--op-library") opt->op_library = v;
    else {
      std::cerr << "unknown arg: " << a << "\n";
      return false;
    }
  }
  return !opt->program.empty();
}

}  // namespace

int main(int argc, char** argv) {
  Options opt;
  if (!parse_args(argc, argv, &opt)) {
    std::cerr << "usage: aoti_runner --program <name.aoti.pt2> [--device cuda|cpu] "
                 "[--batch N] [--height H] [--width W] [--iters N] [--warmup N] "
                 "[--input raw.bin] [--dump-output prefix] "
                 "[--sidecar name.yaml] [--op-library path]\n";
    return 2;
  }

  try {
    const c10::Device device(opt.device);
    const bool cuda = device.is_cuda();
    if (!cuda && !device.is_cpu())
      throw std::runtime_error("--device " + opt.device + ": cuda or cpu");
    if (cuda && !torch::cuda::is_available())
      throw std::runtime_error("--device " + opt.device + ": CUDA is not available");
    const c10::DeviceIndex index = cuda ? (device.has_index() ? device.index() : 0) : -1;

    const OpLibrary lib = open_op_library(opt.op_library);
    const std::string sidecar = opt.sidecar.empty() ? sidecar_of(opt.program) : opt.sidecar;
    const size_t n_outputs = configure(JsonReader(read_file(sidecar)).read(), lib);

    std::cout << "platform: " << (cuda ? "cuda" : "cpu") << "\n";
    torch::inductor::AOTIModelPackageLoader loader(opt.program, "model", false, 1, index);
    std::cout << "compiled " << opt.program << " (" << n_outputs << " outputs)\n";

    std::vector<uint8_t> image(opt.batch * opt.height * opt.width * 3, 114);
    if (!opt.input.empty()) {
      std::ifstream f(opt.input, std::ios::binary);
      if (!f) throw std::runtime_error("cannot open --input " + opt.input);
      f.read(reinterpret_cast<char*>(image.data()), static_cast<std::streamsize>(image.size()));
      if (f.gcount() != static_cast<std::streamsize>(image.size()))
        throw std::runtime_error("--input smaller than batch*h*w*3 bytes");
    }
    const std::vector<at::Tensor> inputs = {
        at::from_blob(image.data(), {opt.batch, opt.height, opt.width, 3}, at::kByte)
            .to(c10::Device(device.type(), index))};
    auto sync = [&] {
      if (cuda) torch::cuda::synchronize(index);
    };

    for (int i = 0; i < opt.warmup; ++i) loader.run(inputs);
    sync();

    if (!opt.dump_output.empty()) {
      // one verification call whose outputs are written for numeric comparison
      // against the Python artifact
      std::vector<at::Tensor> outs = loader.run(inputs);
      for (size_t i = 0; i < outs.size(); ++i) {
        at::Tensor host = outs[i].contiguous().cpu();
        const std::string path = opt.dump_output + ".out" + std::to_string(i) + ".bin";
        std::ofstream f(path, std::ios::binary);
        f.write(static_cast<const char*>(host.data_ptr()),
                static_cast<std::streamsize>(host.nbytes()));
        std::cout << "wrote " << path << " (" << host.nbytes() << " bytes)\n";
      }
    }

    sync();
    auto t0 = std::chrono::steady_clock::now();
    for (int i = 0; i < opt.iters; ++i) loader.run(inputs);
    sync();
    auto t1 = std::chrono::steady_clock::now();
    double ms = std::chrono::duration_cast<std::chrono::microseconds>(t1 - t0).count() / 1000.0;
    double per_img = ms / (opt.iters * opt.batch);
    double img_per_sec = 1000.0 / per_img;
    std::cout << "benchmark: " << opt.iters << " iters of (" << opt.batch << ", " << opt.height
              << ", " << opt.width << ", 3) uint8\n"
              << "total " << ms << " ms, " << per_img << " ms/img, " << img_per_sec
              << " img/s\n";
    std::cout << "early_pipeline launches: " << lib.launches() << " (warm-up " << opt.warmup
              << ", verification " << (opt.dump_output.empty() ? 0 : 1) << ", timed "
              << opt.iters << ")\n";
  } catch (const std::exception& e) {
    std::cerr << "error: " << e.what() << "\n";
    return 1;
  }
  return 0;
}
