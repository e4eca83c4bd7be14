// serl_tpu_torch native transport: the actor<->learner data plane of the
// two-process mode.
//
// The port's own copy of serl_tpu/native/transport.cpp (the same C ABI and
// frames, so the two packages' processes speak the same wire protocol), built
// with g++ by serl_tpu_torch/native/build.py::build_transport and consumed via
// ctypes (serl_tpu_torch/distributed/transport.py). It replaces the
// reference's agentlace (ZeroMQ + lz4) with a dependency-free C++ TCP layer.
// Three patterns, mirroring agentlace's surface:
//   * req/rep RPC            (TrainerClient.request -> server callback)
//   * acknowledged push      (TrainerClient.update -> server data store)
//   * pub/sub broadcast      (TrainerServer.publish_network -> client callback)
//
// Design: one server object owns two listening ports (request + broadcast).
// A background thread per connection reads length-prefixed frames into a
// lock-protected inbound queue; Python drains it with ts_server_recv.
// Publishes fan out to every broadcast subscriber. Clients keep one request
// socket (blocking request/response), one push socket, and one subscribe
// socket drained by ts_client_poll.
//
// Frame format: [u32 len][u8 type][u64 tag][payload...] (len covers
// type+tag+payload). All integers little-endian (x86/ARM hosts).

#include <arpa/inet.h>
#include <cerrno>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <vector>
#include <atomic>
#include <condition_variable>

namespace {

enum MsgType : uint8_t {
  MSG_REQUEST = 1,
  MSG_RESPONSE = 2,
  MSG_PUSH = 3,
  MSG_BROADCAST = 4,
};

struct Frame {
  uint8_t type;
  uint64_t tag;
  std::vector<uint8_t> payload;
};

bool read_exact(int fd, void* buf, size_t n) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_exact(int fd, const void* buf, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool read_frame(int fd, Frame* f) {
  uint32_t len;
  if (!read_exact(fd, &len, 4)) return false;
  if (len < 9 || len > (1u << 31)) return false;
  if (!read_exact(fd, &f->type, 1)) return false;
  if (!read_exact(fd, &f->tag, 8)) return false;
  f->payload.resize(len - 9);
  if (!f->payload.empty() && !read_exact(fd, f->payload.data(), f->payload.size()))
    return false;
  return true;
}

bool write_frame(int fd, uint8_t type, uint64_t tag, const uint8_t* data,
                 uint32_t n) {
  uint32_t len = 9 + n;
  std::vector<uint8_t> buf(4 + len);
  memcpy(buf.data(), &len, 4);
  buf[4] = type;
  memcpy(buf.data() + 5, &tag, 8);
  if (n) memcpy(buf.data() + 13, data, n);
  return write_exact(fd, buf.data(), buf.size());
}

int make_listener(int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = INADDR_ANY;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(fd, 64) < 0) {
    ::close(fd);
    return -1;
  }
  return fd;
}

int make_conn(const char* host, int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    ::close(fd);
    return -1;
  }
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    ::close(fd);
    return -1;
  }
  // Reject TCP self-connection: connecting to a localhost port with no
  // listener can have the kernel pick the TARGET port as the ephemeral
  // source port, and the socket connects to itself (simultaneous open).
  // The phantom ESTABLISHED socket then OCCUPIES the port and blocks a
  // restarted server from binding it — observed in the learner-restart
  // test as a permanent "could not bind ports" failure.
  sockaddr_in local{}, peer{};
  socklen_t ll = sizeof(local), pl = sizeof(peer);
  if (getsockname(fd, reinterpret_cast<sockaddr*>(&local), &ll) == 0 &&
      getpeername(fd, reinterpret_cast<sockaddr*>(&peer), &pl) == 0 &&
      local.sin_port == peer.sin_port &&
      local.sin_addr.s_addr == peer.sin_addr.s_addr) {
    ::close(fd);
    return -1;
  }
  return fd;
}

struct Inbound {
  uint8_t type;
  uint64_t conn_id;  // who sent it (for responding)
  uint64_t tag;
  std::vector<uint8_t> payload;
};

struct Server {
  int req_listener = -1;
  int pub_listener = -1;
  std::atomic<bool> running{true};
  std::thread req_accept_thread;
  std::thread pub_accept_thread;

  std::mutex conn_mu;
  uint64_t next_conn_id = 1;
  // request-port connections: id -> fd (for responses)
  std::vector<std::pair<uint64_t, int>> req_conns;
  // broadcast subscribers
  std::vector<int> subscribers;
  std::vector<std::thread> conn_threads;

  std::mutex q_mu;
  std::condition_variable q_cv;
  std::deque<Inbound> inbox;

  void serve_req_conn(uint64_t id, int fd) {
    Frame f;
    while (running.load() && read_frame(fd, &f)) {
      std::unique_lock<std::mutex> lk(q_mu);
      inbox.push_back({f.type, id, f.tag, std::move(f.payload)});
      q_cv.notify_one();
    }
    std::lock_guard<std::mutex> lk(conn_mu);
    for (auto it = req_conns.begin(); it != req_conns.end(); ++it) {
      if (it->first == id) {
        ::close(it->second);
        req_conns.erase(it);
        break;
      }
    }
  }

  void accept_req() {
    while (running.load()) {
      int fd = ::accept(req_listener, nullptr, nullptr);
      if (fd < 0) break;
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      uint64_t id;
      {
        std::lock_guard<std::mutex> lk(conn_mu);
        id = next_conn_id++;
        req_conns.emplace_back(id, fd);
      }
      std::lock_guard<std::mutex> lk(conn_mu);
      conn_threads.emplace_back([this, id, fd] { serve_req_conn(id, fd); });
    }
  }

  void accept_pub() {
    while (running.load()) {
      int fd = ::accept(pub_listener, nullptr, nullptr);
      if (fd < 0) break;
      std::lock_guard<std::mutex> lk(conn_mu);
      subscribers.push_back(fd);
    }
  }
};

struct Client {
  // remembered endpoint so a dead connection can be re-established after a
  // learner restart (the actor keeps pushing; see ts_client_push/request)
  std::string host;
  int req_port = 0;
  int pub_port = 0;
  bool subscribed = false;
  int req_fd = -1;
  int push_fd = -1;
  int sub_fd = -1;
  std::mutex req_mu;
  std::mutex push_mu;
  uint64_t next_tag = 1;
  uint64_t next_push_tag = 1;  // guarded by push_mu
};

// Re-dial one client socket (caller holds the matching mutex). Returns the
// new fd or -1.
int redial(Client* c, int* fd, int port) {
  if (*fd >= 0) {
    ::close(*fd);
    *fd = -1;
  }
  int nfd = make_conn(c->host.c_str(), port);
  if (nfd >= 0) *fd = nfd;
  return *fd;
}

uint8_t* copy_out(const std::vector<uint8_t>& v) {
  uint8_t* raw = static_cast<uint8_t*>(malloc(v.empty() ? 1 : v.size()));
  if (!v.empty()) memcpy(raw, v.data(), v.size());
  return raw;
}

}  // namespace

extern "C" {

// ---------------- server ----------------

void* ts_server_create(int req_port, int pub_port) {
  auto* s = new Server();
  s->req_listener = make_listener(req_port);
  s->pub_listener = make_listener(pub_port);
  if (s->req_listener < 0 || s->pub_listener < 0) {
    delete s;
    return nullptr;
  }
  s->req_accept_thread = std::thread([s] { s->accept_req(); });
  s->pub_accept_thread = std::thread([s] { s->accept_pub(); });
  return s;
}

// Pops one inbound message. Returns 1 on success, 0 on timeout.
// Caller must free *payload_out with ts_free.
int ts_server_recv(void* sv, int timeout_ms, uint8_t* type_out,
                   uint64_t* conn_out, uint64_t* tag_out, uint8_t** payload_out,
                   uint32_t* len_out) {
  auto* s = static_cast<Server*>(sv);
  std::unique_lock<std::mutex> lk(s->q_mu);
  if (!s->q_cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                        [s] { return !s->inbox.empty(); }))
    return 0;
  Inbound m = std::move(s->inbox.front());
  s->inbox.pop_front();
  lk.unlock();
  *type_out = m.type;
  *conn_out = m.conn_id;
  *tag_out = m.tag;
  *payload_out = copy_out(m.payload);
  *len_out = static_cast<uint32_t>(m.payload.size());
  return 1;
}

int ts_server_respond(void* sv, uint64_t conn_id, uint64_t tag,
                      const uint8_t* data, uint32_t len) {
  auto* s = static_cast<Server*>(sv);
  int fd = -1;
  {
    std::lock_guard<std::mutex> lk(s->conn_mu);
    for (auto& [id, cfd] : s->req_conns)
      if (id == conn_id) {
        fd = cfd;
        break;
      }
  }
  if (fd < 0) return 0;
  return write_frame(fd, MSG_RESPONSE, tag, data, len) ? 1 : 0;
}

int ts_server_publish(void* sv, const uint8_t* data, uint32_t len) {
  auto* s = static_cast<Server*>(sv);
  std::lock_guard<std::mutex> lk(s->conn_mu);
  int ok = 0;
  for (auto it = s->subscribers.begin(); it != s->subscribers.end();) {
    if (write_frame(*it, MSG_BROADCAST, 0, data, len)) {
      ++ok;
      ++it;
    } else {
      ::close(*it);
      it = s->subscribers.erase(it);
    }
  }
  return ok;
}

void ts_server_destroy(void* sv) {
  auto* s = static_cast<Server*>(sv);
  s->running.store(false);
  ::shutdown(s->req_listener, SHUT_RDWR);
  ::shutdown(s->pub_listener, SHUT_RDWR);
  ::close(s->req_listener);
  ::close(s->pub_listener);
  {
    std::lock_guard<std::mutex> lk(s->conn_mu);
    for (auto& [id, fd] : s->req_conns) ::shutdown(fd, SHUT_RDWR);
    for (int fd : s->subscribers) ::close(fd);
  }
  if (s->req_accept_thread.joinable()) s->req_accept_thread.join();
  if (s->pub_accept_thread.joinable()) s->pub_accept_thread.join();
  for (auto& t : s->conn_threads)
    if (t.joinable()) t.join();
  delete s;
}

// ---------------- client ----------------

void* ts_client_create(const char* host, int req_port, int pub_port,
                       int subscribe) {
  auto* c = new Client();
  c->host = host;
  c->req_port = req_port;
  c->pub_port = pub_port;
  c->subscribed = subscribe != 0;
  c->req_fd = make_conn(host, req_port);
  c->push_fd = make_conn(host, req_port);
  if (subscribe) c->sub_fd = make_conn(host, pub_port);
  if (c->req_fd < 0 || c->push_fd < 0 || (subscribe && c->sub_fd < 0)) {
    delete c;
    return nullptr;
  }
  return c;
}

// Blocking request/response. Returns 1 on success; caller frees payload.
// On a dead connection (learner restarted) re-dials once and retries.
int ts_client_request(void* cv, const uint8_t* data, uint32_t len,
                      uint8_t** payload_out, uint32_t* len_out) {
  auto* c = static_cast<Client*>(cv);
  std::lock_guard<std::mutex> lk(c->req_mu);
  for (int attempt = 0; attempt < 2; ++attempt) {
    if (c->req_fd < 0 && redial(c, &c->req_fd, c->req_port) < 0) return 0;
    uint64_t tag = c->next_tag++;
    if (!write_frame(c->req_fd, MSG_REQUEST, tag, data, len)) {
      ::close(c->req_fd);
      c->req_fd = -1;
      continue;
    }
    Frame f;
    bool ok = true;
    while (true) {
      if (!read_frame(c->req_fd, &f)) {
        ::close(c->req_fd);
        c->req_fd = -1;
        ok = false;
        break;
      }
      if (f.type == MSG_RESPONSE && f.tag == tag) break;
    }
    if (!ok) continue;
    *payload_out = copy_out(f.payload);
    *len_out = static_cast<uint32_t>(f.payload.size());
    return 1;
  }
  return 0;
}

// Acknowledged push; re-dials once on a dead connection so an actor
// survives a learner restart. Returns 1 only after the server ACKs the
// insert (a bare write into a dying socket "succeeds" into the TCP buffer
// and the data is silently lost — delivery needs the round-trip). Returns 0
// if the push was not confirmed (caller should re-queue; duplicates on a
// lost-ack retry are fine for a replay buffer: at-least-once).
int ts_client_push(void* cv, const uint8_t* data, uint32_t len) {
  auto* c = static_cast<Client*>(cv);
  std::lock_guard<std::mutex> lk(c->push_mu);
  for (int attempt = 0; attempt < 2; ++attempt) {
    if (c->push_fd < 0 && redial(c, &c->push_fd, c->req_port) < 0) continue;
    uint64_t tag = c->next_push_tag++;
    if (!write_frame(c->push_fd, MSG_PUSH, tag, data, len)) {
      ::close(c->push_fd);
      c->push_fd = -1;
      continue;
    }
    timeval tv{10, 0};  // ack deadline
    setsockopt(c->push_fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    Frame f;
    bool ok = false;
    while (read_frame(c->push_fd, &f)) {
      if (f.type == MSG_RESPONSE && f.tag == tag) {
        ok = true;
        break;
      }
    }
    if (ok) return 1;
    ::close(c->push_fd);
    c->push_fd = -1;
  }
  return 0;
}

// Poll the subscription socket. Returns 1 with payload, 0 on timeout/none.
// A closed subscription (learner restart) is re-dialed so the next publish
// from the new server reaches this client.
int ts_client_poll(void* cv, int timeout_ms, uint8_t** payload_out,
                   uint32_t* len_out) {
  auto* c = static_cast<Client*>(cv);
  if (!c->subscribed) return 0;
  if (c->sub_fd < 0 && redial(c, &c->sub_fd, c->pub_port) < 0) return 0;
  timeval tv{timeout_ms / 1000, (timeout_ms % 1000) * 1000};
  setsockopt(c->sub_fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  Frame f;
  errno = 0;
  if (!read_frame(c->sub_fd, &f)) {
    if (errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR) {
      // EOF or hard error, not a timeout: drop the socket; re-dialed on the
      // next poll (keeps this call bounded by timeout_ms)
      ::close(c->sub_fd);
      c->sub_fd = -1;
    }
    return 0;
  }
  *payload_out = copy_out(f.payload);
  *len_out = static_cast<uint32_t>(f.payload.size());
  return 1;
}

void ts_client_destroy(void* cv) {
  auto* c = static_cast<Client*>(cv);
  for (int fd : {c->req_fd, c->push_fd, c->sub_fd})
    if (fd >= 0) ::close(fd);
  delete c;
}

void ts_free(uint8_t* p) { free(p); }

}  // extern "C"
