// TCPStore: key-value rendezvous + barrier store over TCP.
//
// The port's own copy of the reference's native/tcp_store.cc (after
// paddle/phi/core/distributed/store/tcp_store.h:121, tcp_utils.cc): the
// blocking set/get/add/wait surface paddle.distributed exposes, as a
// thread-per-connection server holding an in-memory map guarded by a mutex
// and a condvar (waits block server-side, not by polling).
//
// Host code, built by g++ at first use (distributed/store.py) and bound
// with ctypes through the C ABI at the end of this file.

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

enum Cmd : uint8_t {
  kSet = 1,
  kGet = 2,   // blocking until key exists (with client-supplied timeout)
  kAdd = 3,
  kDel = 4,
  kWait = 5,  // blocking existence check
  kNum = 6,
  kCheck = 7, // non-blocking existence check
};

// ---- low-level framed IO ---------------------------------------------------

bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t k = ::send(fd, p, n, MSG_NOSIGNAL);
    if (k <= 0) return false;
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t k = ::recv(fd, p, n, 0);
    if (k <= 0) return false;
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

bool send_bytes(int fd, const std::string& s) {
  int64_t len = static_cast<int64_t>(s.size());
  return send_all(fd, &len, 8) && (s.empty() || send_all(fd, s.data(), s.size()));
}

bool recv_bytes(int fd, std::string* out) {
  int64_t len = 0;
  if (!recv_all(fd, &len, 8) || len < 0 || len > (int64_t)1 << 31) return false;
  out->resize(static_cast<size_t>(len));
  return len == 0 || recv_all(fd, &(*out)[0], static_cast<size_t>(len));
}

// ---- server ----------------------------------------------------------------

class StoreServer {
 public:
  explicit StoreServer(int port) : port_(port) {}

  bool Start() {
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd_ < 0) return false;
    int one = 1;
    ::setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(port_));
    if (::bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0)
      return false;
    if (port_ == 0) {  // ephemeral: report the bound port
      socklen_t alen = sizeof(addr);
      ::getsockname(listen_fd_, reinterpret_cast<sockaddr*>(&addr), &alen);
      port_ = ntohs(addr.sin_port);
    }
    if (::listen(listen_fd_, 128) != 0) return false;
    accept_thread_ = std::thread([this] { AcceptLoop(); });
    return true;
  }

  void Stop() {
    stop_.store(true);
    if (listen_fd_ >= 0) ::shutdown(listen_fd_, SHUT_RDWR);
    if (listen_fd_ >= 0) ::close(listen_fd_);
    {
      // unblock handler threads parked in recv() on live connections
      std::lock_guard<std::mutex> g(conn_mu_);
      for (int fd : conn_fds_) ::shutdown(fd, SHUT_RDWR);
    }
    {
      // wake every waiter so handler threads can exit
      std::lock_guard<std::mutex> g(mu_);
      cv_.notify_all();
    }
    if (accept_thread_.joinable()) accept_thread_.join();
    std::vector<std::thread> handlers;
    {
      std::lock_guard<std::mutex> g(handlers_mu_);
      handlers.swap(handlers_);
    }
    for (auto& t : handlers)
      if (t.joinable()) t.join();
  }

  int port() const { return port_; }

 private:
  void AcceptLoop() {
    while (!stop_.load()) {
      int fd = ::accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) {
        if (stop_.load()) return;
        continue;
      }
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::lock_guard<std::mutex> g(handlers_mu_);
      handlers_.emplace_back([this, fd] { Handle(fd); });
    }
  }

  void Handle(int fd) {
    {
      std::lock_guard<std::mutex> g(conn_mu_);
      conn_fds_.insert(fd);
    }
    while (!stop_.load()) {
      uint8_t cmd = 0;
      if (!recv_all(fd, &cmd, 1)) break;
      std::string key;
      if (!recv_bytes(fd, &key)) break;
      switch (cmd) {
        case kSet: {
          std::string val;
          if (!recv_bytes(fd, &val)) goto done;
          {
            std::lock_guard<std::mutex> g(mu_);
            data_[key] = std::move(val);
            cv_.notify_all();
          }
          uint8_t ok = 1;
          if (!send_all(fd, &ok, 1)) goto done;
          break;
        }
        case kGet:
        case kWait: {
          int64_t timeout_ms = 0;
          if (!recv_all(fd, &timeout_ms, 8)) goto done;
          std::unique_lock<std::mutex> lk(mu_);
          bool found = WaitFor(lk, key, timeout_ms);
          if (cmd == kWait) {
            uint8_t ok = found ? 1 : 0;
            lk.unlock();
            if (!send_all(fd, &ok, 1)) goto done;
          } else {
            if (!found) {
              lk.unlock();
              int64_t neg = -1;
              if (!send_all(fd, &neg, 8)) goto done;
            } else {
              std::string val = data_[key];
              lk.unlock();
              if (!send_bytes(fd, val)) goto done;
            }
          }
          break;
        }
        case kAdd: {
          int64_t delta = 0;
          if (!recv_all(fd, &delta, 8)) goto done;
          int64_t result;
          {
            std::lock_guard<std::mutex> g(mu_);
            int64_t cur = 0;
            auto it = data_.find(key);
            if (it != data_.end() && !it->second.empty())
              cur = std::strtoll(it->second.c_str(), nullptr, 10);
            result = cur + delta;
            data_[key] = std::to_string(result);
            cv_.notify_all();
          }
          if (!send_all(fd, &result, 8)) goto done;
          break;
        }
        case kDel: {
          uint8_t ok;
          {
            std::lock_guard<std::mutex> g(mu_);
            ok = data_.erase(key) ? 1 : 0;
          }
          if (!send_all(fd, &ok, 1)) goto done;
          break;
        }
        case kNum: {
          int64_t n;
          {
            std::lock_guard<std::mutex> g(mu_);
            n = static_cast<int64_t>(data_.size());
          }
          if (!send_all(fd, &n, 8)) goto done;
          break;
        }
        case kCheck: {
          uint8_t ok;
          {
            std::lock_guard<std::mutex> g(mu_);
            ok = data_.count(key) ? 1 : 0;
          }
          if (!send_all(fd, &ok, 1)) goto done;
          break;
        }
        default:
          goto done;
      }
    }
  done:
    {
      std::lock_guard<std::mutex> g(conn_mu_);
      conn_fds_.erase(fd);
    }
    ::close(fd);
  }

  bool WaitFor(std::unique_lock<std::mutex>& lk, const std::string& key,
               int64_t timeout_ms) {
    auto pred = [&] { return stop_.load() || data_.count(key) > 0; };
    if (timeout_ms <= 0) {  // wait "forever" (bounded for robustness)
      cv_.wait_for(lk, std::chrono::hours(24), pred);
    } else {
      cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms), pred);
    }
    return data_.count(key) > 0;
  }

  int port_;
  int listen_fd_ = -1;
  std::atomic<bool> stop_{false};
  std::thread accept_thread_;
  std::mutex handlers_mu_;
  std::vector<std::thread> handlers_;
  std::mutex conn_mu_;
  std::set<int> conn_fds_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::unordered_map<std::string, std::string> data_;
};

// ---- client ----------------------------------------------------------------

class StoreClient {
 public:
  StoreClient(const std::string& host, int port) : host_(host), port_(port) {}

  bool Connect(int timeout_ms) {
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms > 0 ? timeout_ms : 30000);
    while (std::chrono::steady_clock::now() < deadline) {
      // resolve hostname each attempt (DNS may come up after us on clusters)
      addrinfo hints{};
      hints.ai_family = AF_UNSPEC;
      hints.ai_socktype = SOCK_STREAM;
      addrinfo* res = nullptr;
      std::string port_str = std::to_string(port_);
      if (::getaddrinfo(host_.c_str(), port_str.c_str(), &hints, &res) == 0) {
        for (addrinfo* ai = res; ai != nullptr; ai = ai->ai_next) {
          fd_ = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
          if (fd_ < 0) continue;
          if (::connect(fd_, ai->ai_addr, ai->ai_addrlen) == 0) {
            int one = 1;
            ::setsockopt(fd_, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
            ::freeaddrinfo(res);
            return true;
          }
          ::close(fd_);
          fd_ = -1;
        }
        ::freeaddrinfo(res);
      }
      std::this_thread::sleep_for(std::chrono::milliseconds(50));
    }
    return false;
  }

  ~StoreClient() {
    if (fd_ >= 0) ::close(fd_);
  }

  bool Set(const std::string& key, const std::string& val) {
    std::lock_guard<std::mutex> g(mu_);
    uint8_t cmd = kSet;
    if (!send_all(fd_, &cmd, 1) || !send_bytes(fd_, key) ||
        !send_bytes(fd_, val))
      return false;
    uint8_t ok = 0;
    return recv_all(fd_, &ok, 1) && ok == 1;
  }

  // returns false on timeout/error; value in *out
  bool Get(const std::string& key, int64_t timeout_ms, std::string* out) {
    std::lock_guard<std::mutex> g(mu_);
    uint8_t cmd = kGet;
    if (!send_all(fd_, &cmd, 1) || !send_bytes(fd_, key) ||
        !send_all(fd_, &timeout_ms, 8))
      return false;
    int64_t len = 0;
    if (!recv_all(fd_, &len, 8)) return false;
    if (len < 0) return false;
    out->resize(static_cast<size_t>(len));
    return len == 0 || recv_all(fd_, &(*out)[0], static_cast<size_t>(len));
  }

  bool Add(const std::string& key, int64_t delta, int64_t* result) {
    std::lock_guard<std::mutex> g(mu_);
    uint8_t cmd = kAdd;
    if (!send_all(fd_, &cmd, 1) || !send_bytes(fd_, key) ||
        !send_all(fd_, &delta, 8))
      return false;
    return recv_all(fd_, result, 8);
  }

  bool Wait(const std::string& key, int64_t timeout_ms) {
    std::lock_guard<std::mutex> g(mu_);
    uint8_t cmd = kWait;
    if (!send_all(fd_, &cmd, 1) || !send_bytes(fd_, key) ||
        !send_all(fd_, &timeout_ms, 8))
      return false;
    uint8_t ok = 0;
    return recv_all(fd_, &ok, 1) && ok == 1;
  }

  bool Del(const std::string& key) {
    std::lock_guard<std::mutex> g(mu_);
    uint8_t cmd = kDel;
    if (!send_all(fd_, &cmd, 1) || !send_bytes(fd_, key)) return false;
    uint8_t ok = 0;
    return recv_all(fd_, &ok, 1);
  }

  bool Check(const std::string& key, bool* exists) {
    std::lock_guard<std::mutex> g(mu_);
    uint8_t cmd = kCheck;
    if (!send_all(fd_, &cmd, 1) || !send_bytes(fd_, key)) return false;
    uint8_t ok = 0;
    if (!recv_all(fd_, &ok, 1)) return false;
    *exists = ok == 1;
    return true;
  }

  int64_t NumKeys() {
    std::lock_guard<std::mutex> g(mu_);
    uint8_t cmd = kNum;
    std::string empty;
    if (!send_all(fd_, &cmd, 1) || !send_bytes(fd_, empty)) return -1;
    int64_t n = -1;
    recv_all(fd_, &n, 8);
    return n;
  }

 private:
  std::string host_;
  int port_;
  int fd_ = -1;
  std::mutex mu_;  // one outstanding request per client connection
};

}  // namespace

// ---- C ABI -----------------------------------------------------------------

extern "C" {

void* pt_store_server_start(int port) {
  auto* s = new StoreServer(port);
  if (!s->Start()) {
    delete s;
    return nullptr;
  }
  return s;
}

int pt_store_server_port(void* h) {
  return static_cast<StoreServer*>(h)->port();
}

void pt_store_server_stop(void* h) {
  auto* s = static_cast<StoreServer*>(h);
  s->Stop();
  delete s;
}

void* pt_store_client_new(const char* host, int port, int timeout_ms) {
  auto* c = new StoreClient(host, port);
  if (!c->Connect(timeout_ms)) {
    delete c;
    return nullptr;
  }
  return c;
}

void pt_store_client_free(void* h) { delete static_cast<StoreClient*>(h); }

int pt_store_set(void* h, const char* key, const uint8_t* val, int64_t len) {
  return static_cast<StoreClient*>(h)->Set(
             key, std::string(reinterpret_cast<const char*>(val),
                              static_cast<size_t>(len)))
             ? 0
             : -1;
}

// caller frees with pt_buffer_free; returns nullptr on timeout
uint8_t* pt_store_get(void* h, const char* key, int64_t timeout_ms,
                      int64_t* out_len) {
  std::string val;
  if (!static_cast<StoreClient*>(h)->Get(key, timeout_ms, &val)) {
    *out_len = -1;
    return nullptr;
  }
  auto* buf = static_cast<uint8_t*>(::malloc(val.size() ? val.size() : 1));
  std::memcpy(buf, val.data(), val.size());
  *out_len = static_cast<int64_t>(val.size());
  return buf;
}

void pt_buffer_free(void* p) { ::free(p); }

int pt_store_add(void* h, const char* key, int64_t delta, int64_t* result) {
  return static_cast<StoreClient*>(h)->Add(key, delta, result) ? 0 : -1;
}

int pt_store_wait(void* h, const char* key, int64_t timeout_ms) {
  return static_cast<StoreClient*>(h)->Wait(key, timeout_ms) ? 0 : -1;
}

int pt_store_delete(void* h, const char* key) {
  return static_cast<StoreClient*>(h)->Del(key) ? 0 : -1;
}

int pt_store_check(void* h, const char* key) {
  bool exists = false;
  if (!static_cast<StoreClient*>(h)->Check(key, &exists)) return -1;
  return exists ? 1 : 0;
}

int64_t pt_store_num_keys(void* h) {
  return static_cast<StoreClient*>(h)->NumKeys();
}

}  // extern "C"
