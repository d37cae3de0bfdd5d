// Copied from gatekeeper_tpu/native/bridge_frontend.cpp; no line below
// differs. Built with g++ (or $CXX) by gatekeeper_tpu_torch/native/__init__.py
// (build_frontend); served by gatekeeper_tpu_torch/webhook/bridge.py.

// Admission serving bridge, native front half.
//
// The reference's webhook is a Go HTTP server (goroutine per request,
// pkg/webhook/policy.go:141); SURVEY §2.4 row 3 / §7 step 5 reserve a
// native front for this framework: a C++ process that terminates the
// admission HTTP traffic on a thread pool (no Python GIL on the accept
// path) and streams each AdmissionReview body over a Unix socket to the
// Python/JAX batch server (webhook/bridge.py), which micro-batches into
// the fused device dispatch.
//
// Protocol (frontend <-> backend): length-prefixed frames over one Unix
// socket per in-flight request — [u32 big-endian length][payload]. The
// request payload is "<http path>\n<raw AdmissionReview JSON body>"
// (the backend routes /v1/admit vs /v1/admitlabel on the first line);
// the response payload is the complete AdmissionReview response JSON.
//
// Failure semantics mirror the reference's fail-open posture
// (failurePolicy: Ignore, policy.go:80): a backend that is down or
// misses --deadline-ms gets an allow-with-warning response so admission
// never wedges the cluster; the audit sweep remains the backstop.
//
// Build: g++ -O2 -pthread -o bridge_frontend bridge_frontend.cpp
// Run:   bridge_frontend --port 0 --backend /tmp/gk.sock \
//          [--deadline-ms 2000] [--threads 64]
// Prints "LISTENING <port>" on stdout once bound.

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <signal.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <time.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Config {
  int port = 0;
  std::string backend;
  int deadline_ms = 2000;
  int threads = 64;  // accept backlog workers (thread per connection)
};

std::atomic<bool> g_stop{false};

int64_t now_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000 + ts.tv_nsec / 1000000;
}

// blocking write toward the HTTP client (the apiserver side has its own
// webhook timeout; our --deadline-ms governs only the backend hop)
bool write_full(int fd, const void* buf, size_t n) {
  size_t sent = 0;
  const char* p = static_cast<const char*>(buf);
  while (sent < n) {
    ssize_t w = write(fd, p + sent, n - sent);
    if (w <= 0) return false;
    sent += static_cast<size_t>(w);
  }
  return true;
}

// `deadline` is an absolute CLOCK_MONOTONIC ms instant: the whole
// backend round trip shares ONE budget (per-poll timeouts would let a
// trickling or stalled peer stretch it arbitrarily).
ssize_t read_deadline(int fd, void* buf, size_t n, int64_t deadline) {
  size_t got = 0;
  auto* p = static_cast<char*>(buf);
  while (got < n) {
    int remain = static_cast<int>(deadline - now_ms());
    if (remain <= 0) return -1;
    struct pollfd pfd{fd, POLLIN, 0};
    int pr = poll(&pfd, 1, remain);
    if (pr <= 0) return -1;  // timeout or error
    ssize_t r = read(fd, p + got, n - got);
    if (r <= 0) return -1;
    got += static_cast<size_t>(r);
  }
  return static_cast<ssize_t>(got);
}

bool write_deadline(int fd, const void* buf, size_t n, int64_t deadline) {
  size_t sent = 0;
  const char* p = static_cast<const char*>(buf);
  while (sent < n) {
    int remain = static_cast<int>(deadline - now_ms());
    if (remain <= 0) return false;
    struct pollfd pfd{fd, POLLOUT, 0};
    int pr = poll(&pfd, 1, remain);
    if (pr <= 0) return false;
    ssize_t w = write(fd, p + sent, n - sent);
    if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) continue;
    if (w <= 0) return false;
    sent += static_cast<size_t>(w);
  }
  return true;
}

bool connect_deadline(int fd, const struct sockaddr* addr, socklen_t alen,
                      int64_t deadline) {
  int flags = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, flags | O_NONBLOCK);
  int rc = connect(fd, addr, alen);
  if (rc != 0 && errno != EINPROGRESS) return false;
  if (rc != 0) {
    int remain = static_cast<int>(deadline - now_ms());
    if (remain <= 0) return false;
    struct pollfd pfd{fd, POLLOUT, 0};
    if (poll(&pfd, 1, remain) <= 0) return false;
    int err = 0;
    socklen_t elen = sizeof(err);
    if (getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &elen) != 0 || err != 0)
      return false;
  }
  return true;  // socket stays non-blocking; read/write poll anyway
}

// One round trip to the Python batch server; empty string = failure.
// The frame payload is "<path>\n<body>" so the backend can route.
std::string backend_call(const Config& cfg, const std::string& path,
                         const std::string& body) {
  int64_t deadline = now_ms() + cfg.deadline_ms;
  int fd = socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) return "";
  struct sockaddr_un addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sun_family = AF_UNIX;
  std::strncpy(addr.sun_path, cfg.backend.c_str(),
               sizeof(addr.sun_path) - 1);
  if (!connect_deadline(fd, reinterpret_cast<struct sockaddr*>(&addr),
                        sizeof(addr), deadline)) {
    close(fd);
    return "";
  }
  std::string payload = path + "\n" + body;
  uint32_t len = htonl(static_cast<uint32_t>(payload.size()));
  if (!write_deadline(fd, &len, 4, deadline) ||
      !write_deadline(fd, payload.data(), payload.size(), deadline)) {
    close(fd);
    return "";
  }
  uint32_t rlen_be = 0;
  if (read_deadline(fd, &rlen_be, 4, deadline) != 4) {
    close(fd);
    return "";
  }
  uint32_t rlen = ntohl(rlen_be);
  if (rlen > (64u << 20)) {  // 64MB sanity cap
    close(fd);
    return "";
  }
  std::string out(rlen, '\0');
  if (read_deadline(fd, out.data(), rlen, deadline) !=
      static_cast<ssize_t>(rlen)) {
    close(fd);
    return "";
  }
  close(fd);
  return out;
}

// Top-level "uid" of the AdmissionReview's request object, or "".
// Tracks brace depth and string state so a uid nested deeper (e.g.
// request.object.metadata.uid serialized first) can never shadow the
// request's own uid (ADVICE r4: a naive first-"uid" scan returns the
// wrong uid under reordered keys, and the apiserver rejects the
// response).
std::string extract_request_uid(const std::string& body) {
  size_t req = body.find("\"request\"");
  if (req == std::string::npos) return "";
  size_t i = body.find('{', req);
  if (i == std::string::npos) return "";
  int depth = 0;
  while (i < body.size()) {
    char c = body[i];
    if (c == '"') {
      size_t start = ++i;
      while (i < body.size() && body[i] != '"') {
        i += (body[i] == '\\') ? 2 : 1;
      }
      if (i >= body.size()) return "";
      std::string s = body.substr(start, i - start);
      ++i;  // past closing quote
      if (depth == 1) {
        size_t j = body.find_first_not_of(" \t\r\n", i);
        if (j != std::string::npos && body[j] == ':' && s == "uid") {
          size_t k = body.find_first_not_of(" \t\r\n", j + 1);
          if (k == std::string::npos || body[k] != '"') return "";
          size_t vstart = ++k;
          while (k < body.size() && body[k] != '"') {
            k += (body[k] == '\\') ? 2 : 1;
          }
          if (k >= body.size()) return "";
          return body.substr(vstart, k - vstart);
        }
      }
      continue;
    }
    if (c == '{' || c == '[') {
      ++depth;
    } else if (c == '}' || c == ']') {
      if (--depth <= 0) return "";  // left the request object: no uid
    }
    ++i;
  }
  return "";
}

// Fail-open AdmissionReview response (uid copied from the request when
// findable; the apiserver tolerates an empty uid on failurePolicy
// retries, but we extract it for correctness).
std::string fail_open_response(const std::string& body) {
  std::string uid = extract_request_uid(body);
  std::string resp =
      "{\"apiVersion\":\"admission.k8s.io/v1\",\"kind\":\"AdmissionReview\","
      "\"response\":{\"uid\":\"" + uid + "\",\"allowed\":true,"
      "\"warnings\":[\"gatekeeper-tpu backend unavailable or over "
      "deadline; failing open (audit is the backstop)\"]}}";
  return resp;
}

void respond(int fd, int code, const std::string& reason,
             const std::string& body, bool keep_alive) {
  std::string head = "HTTP/1.1 " + std::to_string(code) + " " + reason +
                     "\r\nContent-Type: application/json\r\n"
                     "Content-Length: " + std::to_string(body.size()) +
                     "\r\nConnection: " +
                     (keep_alive ? "keep-alive" : "close") + "\r\n\r\n";
  write_full(fd, head.data(), head.size());
  write_full(fd, body.data(), body.size());
}

// Reads one HTTP request; returns false to close the connection.
// `carry` holds bytes read past the previous request's body on this
// keep-alive connection (pipelined requests); leftovers from THIS
// request are stored back into it (ADVICE r4: truncating them broke
// pipelining).
bool handle_one(const Config& cfg, int fd, std::string& carry) {
  // read until end of headers (the carry may already hold a request)
  std::string buf = std::move(carry);
  carry.clear();
  char tmp[4096];
  size_t header_end = buf.find("\r\n\r\n");
  while (header_end == std::string::npos) {
    struct pollfd pfd{fd, POLLIN, 0};
    // generous idle keep-alive window
    int pr = poll(&pfd, 1, 30000);
    if (pr <= 0) return false;
    ssize_t r = read(fd, tmp, sizeof(tmp));
    if (r <= 0) return false;
    buf.append(tmp, static_cast<size_t>(r));
    header_end = buf.find("\r\n\r\n");
    if (buf.size() > (1u << 20) && header_end == std::string::npos)
      return false;  // oversized headers
  }
  std::string headers = buf.substr(0, header_end);
  std::string body = buf.substr(header_end + 4);

  // request line
  size_t sp1 = headers.find(' ');
  size_t sp2 = headers.find(' ', sp1 + 1);
  if (sp1 == std::string::npos || sp2 == std::string::npos) return false;
  std::string method = headers.substr(0, sp1);
  std::string path = headers.substr(sp1 + 1, sp2 - sp1 - 1);

  // content-length (case-insensitive scan); chunked framing is not
  // implemented — reject it explicitly rather than misparse
  size_t content_length = 0;
  {
    std::string lower = headers;
    for (auto& ch : lower) ch = static_cast<char>(tolower(ch));
    if (lower.find("transfer-encoding:") != std::string::npos) {
      respond(fd, 501, "Not Implemented",
              "{\"error\":\"chunked transfer encoding not supported\"}",
              false);
      return false;
    }
    size_t cl = lower.find("content-length:");
    if (cl != std::string::npos)
      content_length = std::strtoul(lower.c_str() + cl + 15, nullptr, 10);
    if (content_length > (64u << 20)) return false;
  }
  while (body.size() < content_length) {
    struct pollfd pfd{fd, POLLIN, 0};
    int pr = poll(&pfd, 1, 10000);
    if (pr <= 0) return false;
    ssize_t r = read(fd, tmp, sizeof(tmp));
    if (r <= 0) return false;
    body.append(tmp, static_cast<size_t>(r));
  }
  if (body.size() > content_length) {
    carry = body.substr(content_length);  // next pipelined request
    body.resize(content_length);
  }

  if (path == "/healthz") {
    respond(fd, 200, "OK", "{\"ok\":true}", true);
    return true;
  }
  if (method != "POST" ||
      (path != "/v1/admit" && path != "/v1/admitlabel")) {
    respond(fd, 404, "Not Found", "{\"error\":\"not found\"}", true);
    return true;
  }
  std::string out = backend_call(cfg, path, body);
  if (out.empty()) out = fail_open_response(body);
  respond(fd, 200, "OK", out, true);
  return true;
}

std::atomic<int> g_conns{0};

void serve_conn(const Config& cfg, int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  std::string carry;
  while (!g_stop.load() && handle_one(cfg, fd, carry)) {
  }
  close(fd);
  g_conns.fetch_sub(1);
}

}  // namespace

int main(int argc, char** argv) {
  Config cfg;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&](int& i) -> const char* {
      return (i + 1 < argc) ? argv[++i] : "";
    };
    if (a == "--port") cfg.port = std::atoi(next(i));
    else if (a == "--backend") cfg.backend = next(i);
    else if (a == "--deadline-ms") cfg.deadline_ms = std::atoi(next(i));
    else if (a == "--threads") cfg.threads = std::atoi(next(i));
  }
  if (cfg.backend.empty()) {
    std::fprintf(stderr, "--backend <unix socket path> is required\n");
    return 2;
  }
  signal(SIGPIPE, SIG_IGN);

  int lfd = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  struct sockaddr_in addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(cfg.port));
  if (bind(lfd, reinterpret_cast<struct sockaddr*>(&addr),
           sizeof(addr)) != 0 ||
      listen(lfd, 1024) != 0) {
    std::perror("bind/listen");
    return 1;
  }
  socklen_t alen = sizeof(addr);
  getsockname(lfd, reinterpret_cast<struct sockaddr*>(&addr), &alen);
  std::printf("LISTENING %d\n", ntohs(addr.sin_port));
  std::fflush(stdout);

  while (!g_stop.load()) {
    int cfd = accept(lfd, nullptr, nullptr);
    if (cfd < 0) {
      if (errno == EINTR) continue;
      break;
    }
    // thread per keep-alive connection: the apiserver maintains a
    // modest pool of long-lived connections, far below thread limits.
    // Cap concurrency (4x --threads) so a connection flood degrades to
    // 503s instead of unbounded threads x 64MB body buffers (ADVICE r4)
    if (g_conns.load() >= cfg.threads * 4) {
      respond(cfd, 503, "Service Unavailable",
              "{\"error\":\"connection limit reached\"}", false);
      // drain briefly before close: unread request bytes trigger an
      // RST that can discard the queued 503 (the client would see
      // ECONNRESET, not the degraded-but-clean rejection). The bounded
      // drain also backpressures the accept loop under a flood.
      shutdown(cfd, SHUT_WR);
      char sink[4096];
      int64_t drain_deadline = now_ms() + 100;
      for (;;) {
        int remain = static_cast<int>(drain_deadline - now_ms());
        if (remain <= 0) break;
        struct pollfd pfd{cfd, POLLIN, 0};
        if (poll(&pfd, 1, remain) <= 0) break;
        if (read(cfd, sink, sizeof(sink)) <= 0) break;
      }
      close(cfd);
      continue;
    }
    g_conns.fetch_add(1);
    std::thread(serve_conn, std::cref(cfg), cfd).detach();
  }
  close(lfd);
  return 0;
}
