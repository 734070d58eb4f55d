// The native executor's binding: the port's counterpart of
// gofr_tpu/native/pjrt_shim.cpp.
//
// JAX's shim loads a PJRT plugin and runs StableHLO compiled by it. Here the
// compiled program is an AOTInductor model package (.pt2: a torch.export
// graph compiled ahead of time by Inductor into a shared library, Triton
// kernels embedded on a card), and this binding holds one
// torch::inductor::AOTIModelPackageLoader for it. Python sees:
//
//   exe = Executable(path, device_index)   # loads the package
//   exe.run([tensor, ...], stream) -> [tensor, ...]
//   exe.num_inputs, exe.num_outputs, exe.device_type
//   exe.destroy()                          # idempotent
//
// run() holds no GIL while the package executes, so other Python threads
// go on; it launches on `stream` (a cudaStream_t as an integer, 0 for the
// calling thread's current stream) and does not synchronise. A C++ error
// (a bad package, an arity mismatch, a failed run) reaches Python as the
// exception type given to set_error_type(), with the C++ message.
//
// Built on first use by gofr_tpu_torch/native/__init__.py (g++ with
// PyTorch's include and library paths); the input and output counts come
// from the metadata gofr_tpu_torch/native/aoti.py writes into the package.

#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/csrc/utils/pybind.h>

#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace py = pybind11;

namespace {

// The Python exception type C++ errors become (set once by aoti.py).
PyObject* g_error_type = PyExc_RuntimeError;

struct ShimError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

int64_t metadata_count(const std::unordered_map<std::string, std::string>& md,
                       const std::string& key) {
  auto it = md.find(key);
  if (it == md.end()) {
    throw ShimError("package metadata has no " + key +
                    " (not written by gofr_tpu_torch.native.aoti)");
  }
  return std::stoll(it->second);
}

class Executable {
 public:
  Executable(const std::string& path, int64_t device_index) {
    try {
      loader_ = std::make_unique<torch::inductor::AOTIModelPackageLoader>(
          path, "model", /*run_single_threaded=*/false, /*num_runners=*/1,
          static_cast<c10::DeviceIndex>(device_index));
      auto md = loader_->get_metadata();
      num_inputs_ = metadata_count(md, "gofr_num_inputs");
      num_outputs_ = metadata_count(md, "gofr_num_outputs");
      auto dev = md.find("AOTI_DEVICE_KEY");
      device_type_ = dev == md.end() ? "unknown" : dev->second;
    } catch (const ShimError&) {
      throw;
    } catch (const std::exception& e) {
      throw ShimError("load " + path + ": " + e.what());
    }
  }

  std::vector<at::Tensor> run(const std::vector<at::Tensor>& inputs,
                              uintptr_t stream) {
    if (!loader_) {
      throw ShimError("run: the executable was destroyed");
    }
    if (static_cast<int64_t>(inputs.size()) != num_inputs_) {
      throw ShimError("execute: the executable takes " +
                      std::to_string(num_inputs_) + " args, got " +
                      std::to_string(inputs.size()));
    }
    std::vector<at::Tensor> out;
    {
      py::gil_scoped_release no_gil;
      try {
        out = loader_->run(inputs, reinterpret_cast<void*>(stream));
      } catch (const std::exception& e) {
        throw ShimError(std::string("execute: ") + e.what());
      }
    }
    return out;
  }

  void destroy() {
    py::gil_scoped_release no_gil;
    loader_.reset();
  }

  int64_t num_inputs() const { return num_inputs_; }
  int64_t num_outputs() const { return num_outputs_; }
  const std::string& device_type() const { return device_type_; }

 private:
  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader_;
  int64_t num_inputs_ = 0;
  int64_t num_outputs_ = 0;
  std::string device_type_;
};

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.doc() = "gofr_tpu_torch's native executor: AOTInductor packages";
  py::register_exception_translator([](std::exception_ptr p) {
    try {
      if (p) std::rethrow_exception(p);
    } catch (const ShimError& e) {
      PyErr_SetString(g_error_type, e.what());
    }
  });
  m.def("set_error_type", [](py::object type) {
    if (type.ptr() != g_error_type) {
      Py_INCREF(type.ptr());  // held for the life of the process
      g_error_type = type.ptr();
    }
  });
  py::class_<Executable>(m, "Executable")
      .def(py::init<const std::string&, int64_t>(), py::arg("path"),
           py::arg("device_index") = -1)
      .def("run", &Executable::run, py::arg("inputs"), py::arg("stream") = 0)
      .def("destroy", &Executable::destroy)
      .def_property_readonly("num_inputs", &Executable::num_inputs)
      .def_property_readonly("num_outputs", &Executable::num_outputs)
      .def_property_readonly("device_type", &Executable::device_type);
}
