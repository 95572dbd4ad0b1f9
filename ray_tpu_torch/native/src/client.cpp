// C++ client implementation: binary protocol over TCP.
// See ray_tpu_torch/native/include/ray_tpu_client.h and
// ray_tpu_torch/util/client/binary.py (the authoritative wire format).

#include "../include/ray_tpu_client.h"

#include <arpa/inet.h>
#include <cerrno>
#include <cstring>
#include <netdb.h>
#include <sys/socket.h>
#include <unistd.h>

namespace ray_tpu_torch {

namespace {

constexpr char kMagic[] = "RTTCBIN1";
constexpr uint8_t kOpPing = 1;
constexpr uint8_t kOpPut = 2;
constexpr uint8_t kOpGet = 3;
constexpr uint8_t kOpCall = 4;
constexpr uint8_t kOpRelease = 5;

bool SendAll(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) {
      if (w < 0 && errno == EINTR) continue;
      return false;
    }
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool RecvAll(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

void PutU16(std::string* s, uint16_t v) { s->append(reinterpret_cast<char*>(&v), 2); }
void PutU32(std::string* s, uint32_t v) { s->append(reinterpret_cast<char*>(&v), 4); }
void PutF64(std::string* s, double v) { s->append(reinterpret_cast<char*>(&v), 8); }
void PutI64(std::string* s, int64_t v) { s->append(reinterpret_cast<char*>(&v), 8); }

}  // namespace

Arg Arg::Bytes(std::string b) { Arg a; a.kind = kBytes; a.data = std::move(b); return a; }
Arg Arg::Str(std::string s) { Arg a; a.kind = kStr; a.data = std::move(s); return a; }
Arg Arg::Ref(const ObjectID& id) { Arg a; a.kind = kRef; a.ref = id; return a; }
Arg Arg::F64(double v) { Arg a; a.kind = kF64; a.f64 = v; return a; }
Arg Arg::I64(int64_t v) { Arg a; a.kind = kI64; a.i64 = v; return a; }

Client::~Client() { Close(); }

bool Client::Connect(const std::string& host, int port) {
  Close();
  struct addrinfo hints = {};
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  struct addrinfo* res = nullptr;
  const std::string port_str = std::to_string(port);
  if (::getaddrinfo(host.c_str(), port_str.c_str(), &hints, &res) != 0 || !res) {
    last_error_ = "getaddrinfo failed for " + host;
    return false;
  }
  int fd = -1;
  for (struct addrinfo* ai = res; ai; ai = ai->ai_next) {
    fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    if (::connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
    ::close(fd);
    fd = -1;
  }
  ::freeaddrinfo(res);
  if (fd < 0) {
    last_error_ = "connect failed to " + host + ":" + port_str;
    return false;
  }
  if (!SendAll(fd, kMagic, 8)) {
    ::close(fd);
    last_error_ = "handshake send failed";
    return false;
  }
  fd_ = fd;
  // a server of another protocol closes the connection, or answers with an
  // error, at the first request: refuse it here, not at the caller's first
  // call
  if (!Ping()) {
    last_error_ = "the server at " + host + ":" + port_str +
                  " refused the ray_tpu_torch binary protocol (RTTCBIN1): " + last_error_;
    Close();
    return false;
  }
  return true;
}

void Client::Close() {
  if (fd_ >= 0) {
    ::close(fd_);
    fd_ = -1;
  }
}

bool Client::Request(uint8_t op, const std::string& payload, std::string* out) {
  if (fd_ < 0) {
    last_error_ = "not connected";
    return false;
  }
  if (payload.size() > UINT32_MAX) {
    last_error_ = "payload too large (max 4 GiB)";
    return false;
  }
  const uint64_t rid = next_rid_++;
  char head[13];
  const uint32_t len = static_cast<uint32_t>(payload.size());
  std::memcpy(head, &len, 4);
  head[4] = static_cast<char>(op);
  std::memcpy(head + 5, &rid, 8);
  if (!SendAll(fd_, head, sizeof(head)) ||
      (!payload.empty() && !SendAll(fd_, payload.data(), payload.size()))) {
    last_error_ = "send failed";
    Close();
    return false;
  }
  char rhead[13];
  if (!RecvAll(fd_, rhead, sizeof(rhead))) {
    last_error_ = "recv failed";
    Close();
    return false;
  }
  uint32_t rlen;
  std::memcpy(&rlen, rhead, 4);
  const uint8_t status = static_cast<uint8_t>(rhead[4]);
  std::string body(rlen, '\0');
  if (rlen && !RecvAll(fd_, body.data(), rlen)) {
    last_error_ = "recv body failed";
    Close();
    return false;
  }
  if (status != 0) {
    last_error_ = body.empty() ? "server error" : body;
    return false;
  }
  *out = std::move(body);
  return true;
}

bool Client::Ping() {
  std::string out;
  return Request(kOpPing, "", &out) && out == "pong";
}

ObjectID Client::Put(const std::string& bytes) {
  ObjectID id;
  std::string out;
  if (!Request(kOpPut, bytes, &out)) return id;
  if (out.size() != 16) {
    last_error_ = "malformed PUT reply";
    return id;
  }
  std::memcpy(id.bytes, out.data(), 16);
  id.valid = true;
  return id;
}

std::string Client::Get(const ObjectID& id, double timeout_s) {
  std::string payload(reinterpret_cast<const char*>(id.bytes), 16);
  PutF64(&payload, timeout_s);
  std::string out;
  if (!Request(kOpGet, payload, &out)) return "";
  return out;
}

ObjectID Client::Call(const std::string& function, const std::vector<Arg>& args) {
  ObjectID invalid;
  if (args.size() > 255) {
    last_error_ = "too many args (max 255)";
    return invalid;
  }
  if (function.size() > 65535) {
    last_error_ = "function name too long";
    return invalid;
  }
  std::string payload;
  PutU16(&payload, static_cast<uint16_t>(function.size()));
  payload += function;
  payload.push_back(static_cast<char>(args.size()));
  for (const Arg& a : args) {
    payload.push_back(static_cast<char>(a.kind));
    switch (a.kind) {
      case Arg::kBytes:
      case Arg::kStr:
        PutU32(&payload, static_cast<uint32_t>(a.data.size()));
        payload += a.data;
        break;
      case Arg::kRef:
        PutU32(&payload, 16);
        payload.append(reinterpret_cast<const char*>(a.ref.bytes), 16);
        break;
      case Arg::kF64:
        PutU32(&payload, 8);
        PutF64(&payload, a.f64);
        break;
      case Arg::kI64:
        PutU32(&payload, 8);
        PutI64(&payload, a.i64);
        break;
    }
  }
  ObjectID id;
  std::string out;
  if (!Request(kOpCall, payload, &out)) return id;
  if (out.size() != 16) {
    last_error_ = "malformed CALL reply";
    return id;
  }
  std::memcpy(id.bytes, out.data(), 16);
  id.valid = true;
  return id;
}

bool Client::Release(const ObjectID& id) {
  std::string out;
  return Request(kOpRelease, std::string(reinterpret_cast<const char*>(id.bytes), 16), &out);
}

}  // namespace ray_tpu_torch
