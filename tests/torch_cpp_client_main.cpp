// The port's end-to-end C++ frontend test driver (built by
// ray_tpu_torch/native/_build.py's program() and run against a live
// ray_tpu_torch thin-client server by tests/test_torch_client.py and
// chip_smoke.py). The same checks as tests/cpp_client_main.cpp, over the
// port's client (namespace ray_tpu_torch): Put/Get round-trip,
// cross-language Call by importable name, Ref args, and Release.
//
// usage: torch_cpp_client_main host port [module]
//   module names the Python module holding format_sum and reverse_bytes
//   (default tests.cpp_client_funcs).

#include <cstdio>
#include <cstdlib>
#include <string>

#include "ray_tpu_client.h"

#define CHECK(cond, msg)                      \
  do {                                        \
    if (!(cond)) {                            \
      std::fprintf(stderr, "FAIL: %s (%s)\n", \
                   msg, c.last_error().c_str()); \
      return 1;                               \
    }                                         \
  } while (0)

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s host port [module]\n", argv[0]);
    return 2;
  }
  const std::string module = argc > 3 ? argv[3] : "tests.cpp_client_funcs";
  ray_tpu_torch::Client c;
  CHECK(c.Connect(argv[1], std::atoi(argv[2])), "connect");
  CHECK(c.Ping(), "ping");
  std::printf("ping ok\n");

  // put/get round trip
  ray_tpu_torch::ObjectID id = c.Put("hello from c++");
  CHECK(id.valid, "put");
  CHECK(c.Get(id) == "hello from c++", "get round-trip");
  std::printf("put/get ok\n");

  // cross-language call: python function by import path, i64 + str args
  ray_tpu_torch::ObjectID r = c.Call(
      module + ":format_sum",
      {ray_tpu_torch::Arg::I64(40), ray_tpu_torch::Arg::I64(2),
       ray_tpu_torch::Arg::Str("answer")});
  CHECK(r.valid, "call");
  CHECK(c.Get(r) == "answer=42", "call result");
  std::printf("call ok\n");

  // ref arg: pass a stored object into a task by reference
  ray_tpu_torch::ObjectID payload = c.Put("abcdef");
  ray_tpu_torch::ObjectID rev = c.Call(module + ":reverse_bytes",
                                       {ray_tpu_torch::Arg::Ref(payload)});
  CHECK(c.Get(rev) == "fedcba", "ref arg");

  // release then get must fail
  CHECK(c.Release(payload), "release");
  std::string gone = c.Get(payload);
  CHECK(gone.empty() && !c.last_error().empty(), "get released ref errors");

  std::printf("CPP CLIENT OK\n");
  return 0;
}
