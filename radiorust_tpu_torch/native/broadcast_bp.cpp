// Capacity-1 broadcast channel with backpressure — native runtime core.
//
// C++ reimplementation of the semantics of the reference's
// src/sync/broadcast_bp.rs (studied, not translated): one value slot; a
// send blocks until every subscribed receiver consumed the previous value
// and at least one receiver exists; each receiver sees every value exactly
// once; teardown on either side unblocks and fails the peer.
//
// The reference gets cross-core pipelining from Tokio tasks; this library
// provides the same lock-step handoff for a *threaded* Python runtime:
// payloads are opaque uintptr tokens (the Python side maps them to
// objects), so the channel itself is GIL-free — device dispatch and host
// I/O overlap across OS threads.
//
// Build: g++ -O2 -shared -fPIC -o libbroadcast_bp.so broadcast_bp.cpp -lpthread

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <mutex>
#include <unordered_map>

namespace {

struct Channel {
  std::mutex mu;
  std::condition_variable cv_send;   // waited by senders
  std::condition_variable cv_recv;   // waited by receivers
  uintptr_t slot = 0;
  uint64_t seq = 0;          // increments per send
  int unseen = 0;            // receivers yet to take the current value
  int receivers = 0;
  int senders = 1;
  int enlisters = 1;         // subscription points keeping send alive
  int next_rid = 1;
  std::unordered_map<int, uint64_t> rx_seen;  // receiver id -> last seq seen
};

}  // namespace

extern "C" {

void* bp_channel_new() { return new Channel(); }

void bp_channel_free(void* ch) { delete static_cast<Channel*>(ch); }

// Returns 0 on success, -1 when no receivers can ever appear (closed).
int bp_send(void* ch_, uintptr_t payload) {
  auto* ch = static_cast<Channel*>(ch_);
  std::unique_lock<std::mutex> lk(ch->mu);
  ch->cv_send.wait(lk, [&] {
    return (ch->enlisters == 0 && ch->receivers == 0) ||
           (ch->unseen == 0 && ch->receivers > 0);
  });
  if (ch->enlisters == 0 && ch->receivers == 0) return -1;
  ch->slot = payload;
  ch->seq++;
  ch->unseen = ch->receivers;
  ch->cv_recv.notify_all();
  return 0;
}

// Non-blocking probe: 1 if a send would proceed now, 0 if it would block,
// -1 if closed.
int bp_can_send(void* ch_) {
  auto* ch = static_cast<Channel*>(ch_);
  std::unique_lock<std::mutex> lk(ch->mu);
  if (ch->enlisters == 0 && ch->receivers == 0) return -1;
  return (ch->unseen == 0 && ch->receivers > 0) ? 1 : 0;
}

void bp_sender_close(void* ch_) {
  auto* ch = static_cast<Channel*>(ch_);
  std::unique_lock<std::mutex> lk(ch->mu);
  ch->senders--;
  ch->cv_recv.notify_all();
}

int bp_subscribe(void* ch_) {
  auto* ch = static_cast<Channel*>(ch_);
  std::unique_lock<std::mutex> lk(ch->mu);
  int rid = ch->next_rid++;
  ch->receivers++;
  ch->rx_seen[rid] = ch->seq;  // sees only values sent after subscribing
  ch->cv_send.notify_all();
  return rid;
}

void bp_unsubscribe(void* ch_, int rid) {
  auto* ch = static_cast<Channel*>(ch_);
  std::unique_lock<std::mutex> lk(ch->mu);
  auto it = ch->rx_seen.find(rid);
  if (it == ch->rx_seen.end()) return;
  // If this receiver had not consumed the current value, release it
  // (cf. the reference's Drop bookkeeping, broadcast_bp.rs:188-198).
  if (it->second != ch->seq && ch->unseen > 0) ch->unseen--;
  ch->rx_seen.erase(it);
  ch->receivers--;
  ch->cv_send.notify_all();
}

// Returns 0 on success (payload in *out), -1 when all senders are gone and
// no further value will arrive.
int bp_recv(void* ch_, int rid, uintptr_t* out) {
  auto* ch = static_cast<Channel*>(ch_);
  std::unique_lock<std::mutex> lk(ch->mu);
  uint64_t seen = ch->rx_seen[rid];
  ch->cv_recv.wait(lk, [&] {
    return ch->seq != seen || ch->senders == 0;
  });
  if (ch->seq == seen) return -1;  // senders gone
  ch->rx_seen[rid] = ch->seq;
  *out = ch->slot;
  if (--ch->unseen == 0) ch->cv_send.notify_all();
  return 0;
}

// Timed variant: ms < 0 blocks forever; returns -2 on timeout.
int bp_recv_timeout(void* ch_, int rid, uintptr_t* out, int ms) {
  auto* ch = static_cast<Channel*>(ch_);
  std::unique_lock<std::mutex> lk(ch->mu);
  uint64_t seen = ch->rx_seen[rid];
  auto pred = [&] { return ch->seq != seen || ch->senders == 0; };
  if (ms < 0) {
    ch->cv_recv.wait(lk, pred);
  } else if (!ch->cv_recv.wait_for(lk, std::chrono::milliseconds(ms),
                                   pred)) {
    return -2;
  }
  if (ch->seq == seen) return -1;
  ch->rx_seen[rid] = ch->seq;
  *out = ch->slot;
  if (--ch->unseen == 0) ch->cv_send.notify_all();
  return 0;
}

void bp_enlister_retain(void* ch_) {
  auto* ch = static_cast<Channel*>(ch_);
  std::unique_lock<std::mutex> lk(ch->mu);
  ch->enlisters++;
}

void bp_enlister_release(void* ch_) {
  auto* ch = static_cast<Channel*>(ch_);
  std::unique_lock<std::mutex> lk(ch->mu);
  ch->enlisters--;
  ch->cv_send.notify_all();
}

}  // extern "C"
