// Stand-ins that let a CPU-only build of torch trace fake CUDA tensors
// (the dry-run's FakeTensorMode on device "cuda"); nothing here touches a
// device, and a real CUDA tensor still cannot be made.
//
//  * a CUDA device guard: c10's FakeGuardImpl, which keeps a current
//    device index and nothing else (Python indexing and .to("cuda") set
//    a guard on their tensor's device);
//  * CUDA hooks that report one device, so that CUDA is the accelerator
//    the autograd engine asks for before a backward over CUDA tensors.
//
// torch reads its CUDA hooks once, when it is imported: the library is
// loaded before torch (repro_torch/launch/fake_cuda.py).
#include <ATen/detail/CUDAHooksInterface.h>
#include <c10/core/impl/FakeGuardImpl.h>

C10_REGISTER_GUARD_IMPL(CUDA, c10::impl::FakeGuardImpl<c10::DeviceType::CUDA>);

namespace at {

// Registered under the name the CUDA build's hooks take, which is the
// name getCUDAHooks() looks up.
struct CUDAHooks final : CUDAHooksInterface {
  explicit CUDAHooks(CUDAHooksArgs) {}
  bool hasCUDA() const override { return true; }
  bool isBuilt() const override { return true; }
  bool isAvailable() const override { return true; }
  bool hasPrimaryContext(c10::DeviceIndex) const override { return true; }
  c10::DeviceIndex deviceCount() const override { return 1; }
  c10::DeviceIndex getCurrentDevice() const override { return 0; }
  c10::DeviceIndex current_device() const override { return 0; }
  int getNumGPUs() const override { return 1; }
};

REGISTER_CUDA_HOOKS(CUDAHooks);

}  // namespace at
