// Minimal TCP framing shared by the parameter server and its clients.
//
// The port's own copy of paddle_tpu/_native/csrc/net.h: paddle's socket
// plumbing (paddle/fluid/distributed/store/tcp_utils.h and the brpc
// transport under distributed/ps/service/) as a tiny length-prefixed
// binary protocol instead of brpc: a trainer's host only needs low-rate
// pull/push/rendezvous traffic, not a full RPC stack.
#pragma once

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace ptnet {

inline bool read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r == 0) return false;  // peer closed
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

inline bool write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// Listen on host:port (port 0 -> ephemeral). Returns fd or -1.
// Bind interface: explicit `host` arg, else $PADDLE_BIND_HOST, else ANY
// (multi-host pods need ANY; single-host users can pin 127.0.0.1).
inline int listen_on(int port, int backlog = 128,
                     const char* host = nullptr) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  if (host == nullptr) host = ::getenv("PADDLE_BIND_HOST");
  if (host == nullptr) {
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
  } else if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    ::close(fd);
    return -1;  // fail loudly: a bad bind host must not widen to ANY
  }
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(fd, backlog) < 0) {
    ::close(fd);
    return -1;
  }
  return fd;
}

inline int bound_port(int fd) {
  sockaddr_in addr;
  socklen_t len = sizeof(addr);
  if (::getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &len) < 0) return -1;
  return ntohs(addr.sin_port);
}

// Connect with retry (the server may not be up yet — reference retries in
// TCPStore::connect too). timeout_ms < 0 means retry forever.
inline int connect_to(const std::string& host, int port, int timeout_ms) {
  sockaddr_in addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1) {
    // very small resolver: "localhost" only; callers pass numeric IPs
    if (host == "localhost") {
      ::inet_pton(AF_INET, "127.0.0.1", &addr.sin_addr);
    } else {
      return -1;
    }
  }
  int waited = 0;
  for (;;) {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0) {
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      return fd;
    }
    ::close(fd);
    if (timeout_ms >= 0 && waited >= timeout_ms) return -1;
    ::usleep(50 * 1000);
    waited += 50;
  }
}

// ------------------------- message helpers ---------------------------------

struct Writer {
  std::vector<char> buf;
  void u8(uint8_t v) { push(&v, 1); }
  void i32(int32_t v) { push(&v, 4); }
  void u32(uint32_t v) { push(&v, 4); }
  void i64(int64_t v) { push(&v, 8); }
  void u64(uint64_t v) { push(&v, 8); }
  void f32(float v) { push(&v, 4); }
  void bytes(const void* p, size_t n) { push(p, n); }
  void str(const std::string& s) {
    u32(static_cast<uint32_t>(s.size()));
    push(s.data(), s.size());
  }
  void push(const void* p, size_t n) {
    const char* c = static_cast<const char*>(p);
    buf.insert(buf.end(), c, c + n);
  }
};

// Bounds-checked deserializer. Servers feed frames from untrusted peers
// into this; every read validates against the frame end. On a violation
// the reader latches failed() and returns zeros/empties — callers MUST
// check failed() before acting on a decoded frame (the PS/TCPStore request
// loops drop the connection).
struct Reader {
  const char* p;
  const char* end;
  bool failed_ = false;
  Reader(const char* data, size_t n) : p(data), end(data + n) {}
  bool ok(size_t n) const { return !failed_ && n <= static_cast<size_t>(end - p); }
  bool failed() const { return failed_; }
  uint8_t u8() { return take<uint8_t>(); }
  int32_t i32() { return take<int32_t>(); }
  uint32_t u32() { return take<uint32_t>(); }
  int64_t i64() { return take<int64_t>(); }
  uint64_t u64() { return take<uint64_t>(); }
  float f32() { return take<float>(); }
  std::string str() {
    uint32_t n = u32();
    if (!ok(n)) {
      failed_ = true;
      return std::string();
    }
    std::string s(p, p + n);
    p += n;
    return s;
  }
  // Returns nullptr (and latches failure) if fewer than n bytes remain.
  const char* raw(size_t n) {
    if (!ok(n)) {
      failed_ = true;
      return nullptr;
    }
    const char* r = p;
    p += n;
    return r;
  }
  template <typename T>
  T take() {
    if (!ok(sizeof(T))) {
      failed_ = true;
      return T();
    }
    T v;
    std::memcpy(&v, p, sizeof(T));
    p += sizeof(T);
    return v;
  }
};

// Send one frame: [u32 len][body]. Receive fills `out` with body.
inline bool send_frame(int fd, const Writer& w) {
  uint32_t len = static_cast<uint32_t>(w.buf.size());
  if (!write_full(fd, &len, 4)) return false;
  return write_full(fd, w.buf.data(), w.buf.size());
}

// Frames larger than this are treated as a protocol error (a malicious or
// corrupt length prefix would otherwise drive a multi-GiB allocation).
// Clients chunk dense and sparse transfers (client.py _DENSE_CHUNK /
// _SPARSE_CHUNK_BYTES) so every legitimate frame stays far below this.
constexpr uint32_t kMaxFrameLen = 256u * 1024u * 1024u;

inline bool recv_frame(int fd, std::vector<char>* out) {
  uint32_t len = 0;
  if (!read_full(fd, &len, 4)) return false;
  if (len > kMaxFrameLen) return false;
  out->resize(len);
  if (len == 0) return true;
  return read_full(fd, out->data(), len);
}

}  // namespace ptnet
