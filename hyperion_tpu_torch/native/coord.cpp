// coord: host-side rendezvous + barrier + failure detection over TCP.
//
// Role (SURVEY §2.3, §5.3): the reference's host-coordination plane is
// torchrun's env:// rendezvous plus NCCL's watchdog timeouts
// (distributed_utils.py:101-112, run_language_fsdp.sh:8-12). JAX's
// coordinator covers rendezvous for collectives; this in-tree native
// layer adds what the reference *operationally* relied on and JAX does
// not expose: a pre-flight host handshake with hard timeouts, named
// barriers usable outside any JAX context (e.g. around checkpoint IO),
// and peer-death detection (a closed socket fails the barrier rather
// than hanging for the collective timeout).
//
// Protocol: coordinator (process 0) accepts `world-1` connections; each
// worker sends HELLO{rank}. A barrier is BARRIER{seq} from every rank;
// the coordinator replies RELEASE{seq} to all once the set is complete.
// All reads honor a deadline; any socket error marks the peer dead and
// fails subsequent barriers fast. Consumed via ctypes (no pybind11).

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <vector>

namespace {

constexpr uint32_t kHello = 0x48454C4F;    // "HELO"
constexpr uint32_t kBarrier = 0x42415252;  // "BARR"
constexpr uint32_t kRelease = 0x52454C53;  // "RELS"

struct Msg {
  uint32_t kind;
  uint32_t value;
};

int64_t now_ms() {
  using namespace std::chrono;
  return duration_cast<milliseconds>(
             steady_clock::now().time_since_epoch()).count();
}

// Reads exactly n bytes before deadline_ms; 0 ok, -1 error/peer-dead,
// -2 timeout.
int read_full(int fd, void* buf, size_t n, int64_t deadline_ms) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    int64_t left = deadline_ms - now_ms();
    if (left <= 0) return -2;
    pollfd pfd{fd, POLLIN, 0};
    int pr = ::poll(&pfd, 1, static_cast<int>(left));
    if (pr < 0 && errno != EINTR) return -1;
    if (pr == 0) return -2;
    if (pr < 0) continue;
    ssize_t got = ::recv(fd, p, n, 0);
    if (got <= 0) return -1;  // 0 = orderly shutdown → peer dead
    p += got;
    n -= got;
  }
  return 0;
}

int write_full(int fd, const void* buf, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t sent = ::send(fd, p, n, MSG_NOSIGNAL);
    if (sent <= 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    p += sent;
    n -= sent;
  }
  return 0;
}

struct Coord {
  bool is_coordinator = false;
  int world = 0;
  int listen_fd = -1;
  int sock = -1;                  // worker: connection to coordinator
  std::vector<int> peers;         // coordinator: sockets by rank (0 unused)
  std::vector<uint8_t> alive;     // coordinator: liveness by rank
  uint32_t seq = 0;
};

void set_opts(int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

}  // namespace

extern "C" {

// Coordinator (rank 0): listen on port and accept world-1 HELLOs.
// Returns handle or null. timeout_ms bounds the whole rendezvous.
void* hypcoord_serve(int port, int world, int timeout_ms) {
  int lfd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (lfd < 0) return nullptr;
  int one = 1;
  ::setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(lfd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      ::listen(lfd, world) != 0) {
    ::close(lfd);
    return nullptr;
  }
  Coord* c = new Coord();
  c->is_coordinator = true;
  c->world = world;
  c->listen_fd = lfd;
  c->peers.assign(world, -1);
  c->alive.assign(world, 0);
  c->alive[0] = 1;

  int64_t deadline = now_ms() + timeout_ms;
  int joined = 1;  // self
  while (joined < world) {
    int64_t left = deadline - now_ms();
    if (left <= 0) break;
    pollfd pfd{lfd, POLLIN, 0};
    int pr = ::poll(&pfd, 1, static_cast<int>(left));
    if (pr <= 0) {
      if (pr < 0 && errno == EINTR) continue;
      break;
    }
    int fd = ::accept(lfd, nullptr, nullptr);
    if (fd < 0) continue;
    set_opts(fd);
    Msg m{};
    if (read_full(fd, &m, sizeof(m), deadline) != 0 || m.kind != kHello ||
        m.value >= static_cast<uint32_t>(world) || c->peers[m.value] != -1) {
      ::close(fd);
      continue;
    }
    c->peers[m.value] = fd;
    c->alive[m.value] = 1;
    ++joined;
  }
  if (joined < world) {
    for (int fd : c->peers) if (fd >= 0) ::close(fd);
    ::close(lfd);
    delete c;
    return nullptr;
  }
  return c;
}

// Worker (rank > 0): connect + HELLO. Returns handle or null.
void* hypcoord_connect(const char* host, int port, int rank, int timeout_ms) {
  int64_t deadline = now_ms() + timeout_ms;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) return nullptr;
  int fd = -1;
  while (now_ms() < deadline) {  // retry until the coordinator is up
    fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return nullptr;
    if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0) break;
    ::close(fd);
    fd = -1;
    ::usleep(50 * 1000);
  }
  if (fd < 0) return nullptr;
  set_opts(fd);
  Msg hello{kHello, static_cast<uint32_t>(rank)};
  if (write_full(fd, &hello, sizeof(hello)) != 0) {
    ::close(fd);
    return nullptr;
  }
  Coord* c = new Coord();
  c->world = 0;  // unknown/unneeded on workers
  c->sock = fd;
  return c;
}

// Named barrier. 0 ok, -1 peer failure, -2 timeout, -3 bad handle.
int hypcoord_barrier(void* handle, int timeout_ms) {
  Coord* c = static_cast<Coord*>(handle);
  if (!c) return -3;
  int64_t deadline = now_ms() + timeout_ms;
  uint32_t seq = ++c->seq;
  if (c->is_coordinator) {
    for (int rank = 1; rank < c->world; ++rank) {
      if (!c->alive[rank]) return -1;
      Msg m{};
      int rc = read_full(c->peers[rank], &m, sizeof(m), deadline);
      if (rc != 0 || m.kind != kBarrier || m.value != seq) {
        if (rc == -2) return -2;
        c->alive[rank] = 0;  // dead peer: fail fast from now on
        return -1;
      }
    }
    Msg rel{kRelease, seq};
    int ret = 0;
    for (int rank = 1; rank < c->world; ++rank) {
      if (write_full(c->peers[rank], &rel, sizeof(rel)) != 0) {
        c->alive[rank] = 0;
        ret = -1;
      }
    }
    return ret;
  }
  Msg m{kBarrier, seq};
  if (write_full(c->sock, &m, sizeof(m)) != 0) return -1;
  Msg rel{};
  int rc = read_full(c->sock, &rel, sizeof(rel), deadline);
  if (rc == -2) return -2;
  if (rc != 0 || rel.kind != kRelease || rel.value != seq) return -1;
  return 0;
}

// Coordinator-side liveness count (workers return -1).
int hypcoord_alive_count(void* handle) {
  Coord* c = static_cast<Coord*>(handle);
  if (!c || !c->is_coordinator) return -1;
  int n = 0;
  for (uint8_t a : c->alive) n += a;
  return n;
}

void hypcoord_close(void* handle) {
  Coord* c = static_cast<Coord*>(handle);
  if (!c) return;
  if (c->sock >= 0) ::close(c->sock);
  for (int fd : c->peers) if (fd >= 0) ::close(fd);
  if (c->listen_fd >= 0) ::close(c->listen_fd);
  delete c;
}

}  // extern "C"
