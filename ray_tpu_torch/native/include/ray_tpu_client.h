// ray_tpu_torch C++ client: the native/cross-language frontend.
//
// The port's copy of the JAX package's native client, in a namespace of its
// own (ray_tpu_torch) and speaking the port's binary protocol (magic
// RTTCBIN1): Connect() pings the server and fails, with last_error() set,
// on a server that does not answer that protocol (the JAX package's).
//
// Parity with the reference's C++ user API surface (cpp/include/ray/api/
// object_ref.h, ray_remote.h) reshaped for this runtime: a thin TCP client
// speaking the binary client protocol (ray_tpu_torch/util/client/binary.py)
// against a ray_tpu_torch thin-client server. Objects are byte strings; tasks are
// Python functions addressed by importable name ("module:function") —
// cross_language.py semantics, where the "driver" may be C++ but compute
// definitions live with the runtime.
//
// Usage:
//   ray_tpu_torch::Client c;
//   if (!c.Connect("127.0.0.1", 10001)) { ... }
//   ray_tpu_torch::ObjectID id = c.Put("hello");
//   std::string v = c.Get(id);
//   ray_tpu_torch::ObjectID r = c.Call("mymod:double_it", {ray_tpu_torch::Arg::I64(21)});
//   std::string result = c.Get(r);

#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace ray_tpu_torch {

struct ObjectID {
  uint8_t bytes[16];
  bool valid = false;
};

struct Arg {
  enum Kind : uint8_t { kBytes = 0, kRef = 1, kStr = 2, kF64 = 3, kI64 = 4 };
  Kind kind;
  std::string data;     // BYTES / STR payload
  ObjectID ref;         // REF payload
  double f64 = 0;
  int64_t i64 = 0;

  static Arg Bytes(std::string b);
  static Arg Str(std::string s);
  static Arg Ref(const ObjectID& id);
  static Arg F64(double v);
  static Arg I64(int64_t v);
};

class Client {
 public:
  Client() = default;
  ~Client();
  Client(const Client&) = delete;
  Client& operator=(const Client&) = delete;

  // Connect, send the binary-mode magic and ping. Returns false on failure
  // (last_error() says why), a server that refuses the protocol included.
  bool Connect(const std::string& host, int port);
  void Close();
  bool Connected() const { return fd_ >= 0; }

  // Liveness probe; returns false on any transport error.
  bool Ping();

  // Store a byte object; returns its id (valid=false on error).
  ObjectID Put(const std::string& bytes);

  // Fetch an object's bytes. timeout_s < 0 waits forever. On error returns
  // empty string and sets last_error().
  std::string Get(const ObjectID& id, double timeout_s = -1.0);

  // Invoke a Python function by importable name with positional args;
  // returns the result object's id immediately (fetch with Get).
  ObjectID Call(const std::string& function, const std::vector<Arg>& args);

  // Drop the server-side reference.
  bool Release(const ObjectID& id);

  const std::string& last_error() const { return last_error_; }

 private:
  bool Request(uint8_t op, const std::string& payload, std::string* out);
  int fd_ = -1;
  uint64_t next_rid_ = 1;
  std::string last_error_;
};

}  // namespace ray_tpu_torch
