// The port's object arena: a copy of the JAX package's
// src/store/tpustore.cc, built by ray_tpu_torch/native/build.py into the
// port's own library directory.  Only the comments differ.
//
// tpustore: node-local shared-memory object arena (plasma counterpart).
//
// Reference counterpart: the plasma store embedded in the raylet
// (reference src/ray/object_manager/plasma/ — ObjectLifecycleManager,
// EvictionPolicy, dlmalloc-on-shm in dlmalloc.cc / shared_memory.cc).
// Design differences, TPU-first:
//   - One sparse shm file per node ("arena") mapped by every process.
//     All metadata (object table, free list, LRU list) lives *inside*
//     the arena, so there is no store server process and no per-request
//     socket round trip: create/get/release are a few hundred ns of
//     shared-memory work under a robust process-shared mutex.  The
//     control plane (object directory, ownership) stays in the GCS.
//   - Object payloads are 64-byte aligned flat buffers so a numpy
//     host array deserialized from the arena aliases shm, and a CUDA
//     tensor is copied from the device straight into its payload.
//   - Client accounting: each object's entry tracks per-pid pin counts
//     so a dead worker's pins can be swept (plasma does this with
//     per-connection accounting; we have no connections).
//
// Concurrency: a single robust PTHREAD_PROCESS_SHARED mutex in the
// header serializes metadata updates (matching plasma's single-threaded
// event loop).  Payload reads/writes happen outside the lock.
//
// Exposed as a C ABI consumed from Python via ctypes
// (ray_tpu_torch/native/store.py).

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <signal.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <new>

namespace {

constexpr uint64_t kMagic = 0x7470757374307265ULL;  // "tpust0re"
constexpr uint32_t kVersion = 3;
constexpr uint64_t kAlign = 64;        // payload alignment (cache line)
constexpr uint64_t kBlockHdr = 64;     // block header size, keeps data aligned
constexpr int kRefSlots = 24;          // distinct pids pinning one object
constexpr int kIdLen = 20;             // ObjectID bytes

inline uint64_t align_up(uint64_t v, uint64_t a) { return (v + a - 1) & ~(a - 1); }

struct RefSlot {
  int32_t pid;
  int32_t count;
};

// Object table entry. 256 bytes.
struct Entry {
  uint8_t id[kIdLen];
  uint8_t state;  // see ST_* below
  uint8_t pending_delete;
  uint16_t pad0;
  uint32_t creator_pid;  // pid that created (and may seal) this entry
  uint64_t offset;  // payload offset from arena base
  uint64_t size;    // user payload size
  int64_t lru_prev; // entry index, -1 = none (head side = most recent)
  int64_t lru_next;
  RefSlot refs[kRefSlots];
};
static_assert(sizeof(Entry) == 256, "Entry must be 256 bytes");

// ST_ORPHAN: entry whose id was re-created while old pins were still live
// (task retry re-storing a return object). Unfindable by id — lookups skip
// it like a tombstone — but its block stays allocated until the remaining
// pins are swept/released.
enum : uint8_t {
  ST_EMPTY = 0, ST_TOMB = 1, ST_CREATED = 2, ST_SEALED = 3, ST_ORPHAN = 4,
};

// Heap block header, 64 bytes so payloads stay 64-aligned.
struct Block {
  uint64_t size;       // total block size incl. this header
  uint64_t prev_size;  // size of physically-previous block (0 if first)
  uint32_t used;
  uint32_t pad;
  int64_t next_free;   // arena offsets of free-list neighbours, -1 = none
  int64_t prev_free;
  uint8_t reserved[kBlockHdr - 40];
};
static_assert(sizeof(Block) == kBlockHdr, "Block header must be 64 bytes");

struct Header {
  uint64_t magic;
  uint32_t version;
  volatile uint32_t initialized;
  uint64_t capacity;    // whole file size
  uint64_t table_off;
  uint64_t table_cap;   // number of entries, power of two
  uint64_t heap_off;
  uint64_t heap_size;
  uint64_t nobjects;
  uint64_t used_bytes;  // heap bytes in used blocks (incl. headers)
  int64_t lru_head;     // most recently used
  int64_t lru_tail;     // least recently used
  int64_t free_head;    // arena offset of first free block, -1 = none
  uint64_t evicted_bytes;
  uint64_t evict_count;
  uint64_t tomb_count;   // ST_TOMB slots; rehash resets to 0
  pthread_mutex_t mu;
};

struct Store {
  uint8_t* base;
  uint64_t capacity;
  int fd;
  Header* hdr() const { return reinterpret_cast<Header*>(base); }
  Entry* table() const { return reinterpret_cast<Entry*>(base + hdr()->table_off); }
  Block* block_at(uint64_t off) const { return reinterpret_cast<Block*>(base + off); }
};

// ---------------------------------------------------------------------------
// Locking (robust: survives a lock-holder dying mid-operation)

int lock(Store* s) {
  int rc = pthread_mutex_lock(&s->hdr()->mu);
  if (rc == EOWNERDEAD) {
    // Previous owner died holding the lock. Metadata may be mid-update;
    // plasma would restart the store — we mark consistent and continue,
    // accepting a possible leaked block (swept by sweep()).
    pthread_mutex_consistent(&s->hdr()->mu);
    rc = 0;
  }
  return rc;
}

void unlock(Store* s) { pthread_mutex_unlock(&s->hdr()->mu); }

// ---------------------------------------------------------------------------
// Free-list allocator (first fit, boundary-tag coalescing)

void freelist_remove(Store* s, Block* b, uint64_t off) {
  Header* h = s->hdr();
  if (b->prev_free >= 0) s->block_at(b->prev_free)->next_free = b->next_free;
  else h->free_head = b->next_free;
  if (b->next_free >= 0) s->block_at(b->next_free)->prev_free = b->prev_free;
  b->next_free = b->prev_free = -1;
}

void freelist_push(Store* s, Block* b, uint64_t off) {
  Header* h = s->hdr();
  b->used = 0;
  b->prev_free = -1;
  b->next_free = h->free_head;
  if (h->free_head >= 0) s->block_at(h->free_head)->prev_free = off;
  h->free_head = static_cast<int64_t>(off);
}

uint64_t heap_end(Header* h) { return h->heap_off + h->heap_size; }

// Allocate a block with at least `need` payload bytes; returns block offset
// or 0 on failure.
uint64_t alloc_block(Store* s, uint64_t need) {
  Header* h = s->hdr();
  uint64_t want = align_up(kBlockHdr + need, kAlign);
  int64_t off = h->free_head;
  while (off >= 0) {
    Block* b = s->block_at(off);
    if (b->size >= want) {
      freelist_remove(s, b, off);
      if (b->size >= want + kBlockHdr + kAlign) {
        // split: remainder becomes a new free block
        uint64_t rem_off = off + want;
        Block* rem = s->block_at(rem_off);
        rem->size = b->size - want;
        rem->prev_size = want;
        rem->used = 0;
        b->size = want;
        uint64_t after = rem_off + rem->size;
        if (after < heap_end(h)) s->block_at(after)->prev_size = rem->size;
        freelist_push(s, rem, rem_off);
      }
      b->used = 1;
      h->used_bytes += b->size;
      return off;
    }
    off = b->next_free;
  }
  return 0;
}

void free_block(Store* s, uint64_t off) {
  Header* h = s->hdr();
  Block* b = s->block_at(off);
  h->used_bytes -= b->size;
  // coalesce with physical next
  uint64_t next_off = off + b->size;
  if (next_off < heap_end(h)) {
    Block* nb = s->block_at(next_off);
    if (!nb->used) {
      freelist_remove(s, nb, next_off);
      b->size += nb->size;
    }
  }
  // coalesce with physical prev
  if (b->prev_size > 0) {
    uint64_t prev_off = off - b->prev_size;
    Block* pb = s->block_at(prev_off);
    if (!pb->used) {
      freelist_remove(s, pb, prev_off);
      pb->size += b->size;
      off = prev_off;
      b = pb;
    }
  }
  uint64_t after = off + b->size;
  if (after < heap_end(h)) s->block_at(after)->prev_size = b->size;
  freelist_push(s, b, off);
}

// ---------------------------------------------------------------------------
// Object table (open addressing, linear probe)

uint64_t id_hash(const uint8_t* id) {
  uint64_t x;
  memcpy(&x, id, 8);
  x ^= x >> 33; x *= 0xff51afd7ed558ccdULL; x ^= x >> 33;
  return x;
}

// Find entry for id; returns index or -1. If `for_insert`, returns the
// first insertable slot (empty/tombstone) when the id is absent.
int64_t table_find(Store* s, const uint8_t* id, bool for_insert) {
  Header* h = s->hdr();
  Entry* t = s->table();
  uint64_t mask = h->table_cap - 1;
  uint64_t i = id_hash(id) & mask;
  int64_t insert_at = -1;
  for (uint64_t probes = 0; probes < h->table_cap; ++probes, i = (i + 1) & mask) {
    Entry& e = t[i];
    if (e.state == ST_EMPTY) {
      if (for_insert) return insert_at >= 0 ? insert_at : static_cast<int64_t>(i);
      return -1;
    }
    if (e.state == ST_TOMB) {
      if (for_insert && insert_at < 0) insert_at = static_cast<int64_t>(i);
      continue;
    }
    if (e.state == ST_ORPHAN) continue;  // unfindable; slot NOT reusable
    if (memcmp(e.id, id, kIdLen) == 0) return static_cast<int64_t>(i);
  }
  return for_insert ? insert_at : -1;
}

int total_refs(const Entry& e) {
  int n = 0;
  for (int i = 0; i < kRefSlots; ++i) n += e.refs[i].count;
  return n;
}

// Find this pid's ref slot, or a free one. When all slots are taken,
// reclaim slots whose pid no longer exists (kill(pid, 0) == ESRCH) —
// crashed readers otherwise exhaust the table. Returns -1 if truly full.
int find_ref_slot(Entry& e, int32_t me) {
  int free_slot = -1;
  for (int i = 0; i < kRefSlots; ++i) {
    if (e.refs[i].pid == me) return i;
    if (free_slot < 0 && e.refs[i].count == 0) free_slot = i;
  }
  if (free_slot >= 0) return free_slot;
  for (int i = 0; i < kRefSlots; ++i) {
    if (kill(e.refs[i].pid, 0) != 0 && errno == ESRCH) {
      e.refs[i].pid = 0;
      e.refs[i].count = 0;
      return i;
    }
  }
  return -1;
}

// ---------------------------------------------------------------------------
// LRU list of sealed objects (head = most recent)

void lru_unlink(Store* s, int64_t idx) {
  Header* h = s->hdr();
  Entry* t = s->table();
  Entry& e = t[idx];
  if (e.lru_prev >= 0) t[e.lru_prev].lru_next = e.lru_next;
  else if (h->lru_head == idx) h->lru_head = e.lru_next;
  if (e.lru_next >= 0) t[e.lru_next].lru_prev = e.lru_prev;
  else if (h->lru_tail == idx) h->lru_tail = e.lru_prev;
  e.lru_prev = e.lru_next = -1;
}

void lru_push_front(Store* s, int64_t idx) {
  Header* h = s->hdr();
  Entry* t = s->table();
  Entry& e = t[idx];
  e.lru_prev = -1;
  e.lru_next = h->lru_head;
  if (h->lru_head >= 0) t[h->lru_head].lru_prev = idx;
  h->lru_head = idx;
  if (h->lru_tail < 0) h->lru_tail = idx;
}

void entry_clear(Store* s, int64_t idx) {
  Entry& e = s->table()[idx];
  lru_unlink(s, idx);
  memset(&e, 0, sizeof(Entry));
  e.state = ST_TOMB;
  s->hdr()->nobjects--;
  s->hdr()->tomb_count++;
}

// Free an object's block and table entry. Caller holds lock.
void drop_object(Store* s, int64_t idx) {
  Entry& e = s->table()[idx];
  if (e.offset > 0) free_block(s, e.offset - kBlockHdr);
  entry_clear(s, idx);
}

// Find an orphaned incarnation of `id` (linear scan; orphans are rare
// and unfindable via probing by design). Returns index or -1.
int64_t find_orphan(Store* s, const uint8_t* id) {
  Header* h = s->hdr();
  Entry* t = s->table();
  for (uint64_t i = 0; i < h->table_cap; ++i) {
    if (t[i].state == ST_ORPHAN && memcmp(t[i].id, id, kIdLen) == 0) {
      return static_cast<int64_t>(i);
    }
  }
  return -1;
}

// Drop one pin held by `pid` on entry idx; applies a deferred/orphan free
// if that was the last pin. Caller holds the lock.
void drop_pin(Store* s, int64_t idx, int32_t pid) {
  Entry& e = s->table()[idx];
  for (int i = 0; i < kRefSlots; ++i) {
    if (e.refs[i].pid == pid && e.refs[i].count > 0) {
      if (--e.refs[i].count == 0) e.refs[i].pid = 0;
      break;
    }
  }
  if (total_refs(e) == 0 &&
      (e.pending_delete || e.state == ST_ORPHAN)) {
    drop_object(s, idx);
  }
}

// Rebuild the object table in place when tombstones dominate, restoring
// O(1) miss lookups (open addressing never un-tombs otherwise). Caller
// holds the lock. LRU order is preserved.
void rehash_table(Store* s) {
  Header* h = s->hdr();
  Entry* t = s->table();
  uint64_t cap = h->table_cap;
  if (h->nobjects >= cap) return;  // no empty slot to reinsert into

  // snapshot live entries + the LRU order (as positions into the snapshot)
  uint64_t nlive = 0;
  for (uint64_t i = 0; i < cap; ++i) {
    if (t[i].state >= ST_CREATED) nlive++;
  }
  Entry* live = new (std::nothrow) Entry[nlive ? nlive : 1];
  int64_t* old_to_live = new (std::nothrow) int64_t[cap];
  if (!live || !old_to_live) {  // allocation failed: skip, try next time
    delete[] live;
    delete[] old_to_live;
    return;
  }
  uint64_t n = 0;
  for (uint64_t i = 0; i < cap; ++i) {
    old_to_live[i] = -1;
    if (t[i].state >= ST_CREATED) {
      live[n] = t[i];
      old_to_live[i] = static_cast<int64_t>(n);
      n++;
    }
  }
  // LRU chain as snapshot positions, head first
  int64_t* lru_order = new (std::nothrow) int64_t[nlive ? nlive : 1];
  uint64_t nlru = 0;
  if (lru_order) {
    for (int64_t idx = h->lru_head; idx >= 0; idx = t[idx].lru_next) {
      lru_order[nlru++] = old_to_live[idx];
    }
  }

  // clear only previously-used slots (a full memset would commit every
  // sparse page of the table)
  for (uint64_t i = 0; i < cap; ++i) {
    if (t[i].state != ST_EMPTY) memset(&t[i], 0, sizeof(Entry));
  }
  h->tomb_count = 0;
  h->lru_head = h->lru_tail = -1;

  // reinsert at canonical probe positions
  int64_t* live_to_new = old_to_live;  // reuse allocation, reindexed by live pos
  uint64_t mask = cap - 1;
  for (uint64_t k = 0; k < n; ++k) {
    uint64_t i = id_hash(live[k].id) & mask;
    while (t[i].state != ST_EMPTY) i = (i + 1) & mask;
    t[i] = live[k];
    t[i].lru_prev = t[i].lru_next = -1;
    live_to_new[k] = static_cast<int64_t>(i);
  }
  // rebuild LRU links in the preserved order (head = most recent): push
  // back-to-front so lru_push_front reconstructs the original chain
  if (lru_order) {
    for (uint64_t k = nlru; k > 0; --k) {
      lru_push_front(s, live_to_new[lru_order[k - 1]]);
    }
  }
  delete[] live;
  delete[] old_to_live;
  delete[] lru_order;
}

void maybe_rehash(Store* s) {
  Header* h = s->hdr();
  if (h->tomb_count > h->table_cap / 2) rehash_table(s);
}

// Evict the single least-recently-used sealed, unpinned object.
// Returns bytes freed (0 if no evictable object exists).
uint64_t evict_one(Store* s) {
  Header* h = s->hdr();
  int64_t idx = h->lru_tail;
  while (idx >= 0) {
    Entry& e = s->table()[idx];
    int64_t prev = e.lru_prev;
    if (e.state == ST_SEALED && total_refs(e) == 0 && !e.pending_delete) {
      uint64_t freed = e.size + kBlockHdr;
      h->evicted_bytes += e.size;
      h->evict_count++;
      drop_object(s, idx);
      return freed;
    }
    idx = prev;
  }
  return 0;
}

// Evict LRU victims until at least `need` heap bytes were freed (or no
// victims remain). Returns bytes freed.
uint64_t evict_lru(Store* s, uint64_t need) {
  uint64_t freed = 0;
  while (freed < need) {
    uint64_t got = evict_one(s);
    if (got == 0) break;
    freed += got;
  }
  return freed;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI

extern "C" {

// Open (and if `create`, initialize) the arena at `path` with `capacity`
// bytes total. Returns an opaque handle or null (errno set).
void* tps_open(const char* path, uint64_t capacity, int create) {
  int fd = -1;
  bool initializer = false;
  if (create) {
    fd = open(path, O_CREAT | O_EXCL | O_RDWR, 0600);
    if (fd >= 0) {
      initializer = true;
      if (ftruncate(fd, static_cast<off_t>(capacity)) != 0) {
        close(fd);
        unlink(path);
        return nullptr;
      }
    } else if (errno != EEXIST) {
      return nullptr;
    }
  }
  if (fd < 0) {
    fd = open(path, O_RDWR);
    if (fd < 0) return nullptr;
    // The creator truncates right after its O_EXCL open; wait out the
    // window where the file still has size 0 so concurrent openers don't
    // fail mmap and silently fall back to a different store layout.
    struct stat st;
    uint64_t sz = 0;
    for (int i = 0; i < 100000; ++i) {
      if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
      sz = static_cast<uint64_t>(st.st_size);
      if (sz > 0) break;
      usleep(100);
    }
    if (sz == 0) { errno = EPROTO; close(fd); return nullptr; }
    capacity = sz;
  }
  void* base = mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) { close(fd); return nullptr; }

  Store* s = new (std::nothrow) Store{static_cast<uint8_t*>(base), capacity, fd};
  if (!s) { munmap(base, capacity); close(fd); return nullptr; }
  Header* h = s->hdr();

  if (initializer) {
    memset(h, 0, sizeof(Header));
    h->magic = kMagic;
    h->version = kVersion;
    h->capacity = capacity;
    // Size the table at one entry per 32 KiB of heap, min 4096, pow2.
    uint64_t want_entries = capacity / (32 * 1024);
    uint64_t cap = 4096;
    while (cap < want_entries) cap <<= 1;
    h->table_cap = cap;
    h->table_off = align_up(sizeof(Header), kAlign);
    uint64_t table_bytes = cap * sizeof(Entry);
    h->heap_off = align_up(h->table_off + table_bytes, kAlign);
    if (h->heap_off + kBlockHdr + kAlign > capacity) {
      errno = EINVAL;  // capacity too small for metadata
      delete s;
      munmap(base, capacity);
      close(fd);
      unlink(path);
      return nullptr;
    }
    h->heap_size = capacity - h->heap_off;
    h->lru_head = h->lru_tail = -1;
    // one big free block spanning the heap
    Block* b = s->block_at(h->heap_off);
    memset(b, 0, sizeof(Block));
    b->size = h->heap_size;
    b->prev_size = 0;
    b->next_free = b->prev_free = -1;
    h->free_head = static_cast<int64_t>(h->heap_off);

    pthread_mutexattr_t attr;
    pthread_mutexattr_init(&attr);
    pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&h->mu, &attr);
    pthread_mutexattr_destroy(&attr);
    __atomic_store_n(&h->initialized, 1, __ATOMIC_RELEASE);
  } else {
    // wait for the initializer to finish (bounded spin)
    for (int i = 0; i < 100000; ++i) {
      if (__atomic_load_n(&h->initialized, __ATOMIC_ACQUIRE) == 1) break;
      usleep(100);
    }
    if (h->magic != kMagic || h->version != kVersion ||
        __atomic_load_n(&h->initialized, __ATOMIC_ACQUIRE) != 1) {
      errno = EPROTO;
      delete s;
      munmap(base, capacity);
      close(fd);
      return nullptr;
    }
  }
  return s;
}

void tps_close(void* handle) {
  Store* s = static_cast<Store*>(handle);
  if (!s) return;
  munmap(s->base, s->capacity);
  close(s->fd);
  delete s;
}

uint64_t tps_capacity(void* handle) {
  return static_cast<Store*>(handle)->hdr()->capacity;
}

// Create an unsealed object; writes payload offset to *out_off.
// Returns 0, or -EEXIST / -ENOMEM / -ENOSPC (table full).
int tps_create(void* handle, const uint8_t* id, uint64_t size,
               uint64_t* out_off, int evict_ok) {
  Store* s = static_cast<Store*>(handle);
  if (lock(s) != 0) return -EAGAIN;
  int64_t existing = table_find(s, id, false);
  if (existing >= 0) {
    Entry& old = s->table()[existing];
    if (old.pending_delete) {
      // Deleted-but-pinned (readers hold process-lifetime pins): orphan the
      // old entry so the id becomes insertable; its block is reclaimed when
      // the pins drop (sweep/release).
      lru_unlink(s, existing);
      if (total_refs(old) == 0) {
        drop_object(s, existing);
      } else {
        old.state = ST_ORPHAN;
      }
    } else {
      unlock(s);
      return -EEXIST;
    }
  }
  int64_t idx = table_find(s, id, true);
  if (idx < 0) { unlock(s); return -ENOSPC; }

  uint64_t block = alloc_block(s, size);
  while (block == 0 && evict_ok) {
    // evict one victim at a time and retry, so recently-used objects
    // survive when a smaller eviction suffices
    if (evict_one(s) == 0) break;
    block = alloc_block(s, size);
  }
  if (block == 0) { unlock(s); return -ENOMEM; }

  // only now is the slot actually consumed (an -ENOMEM above must leave
  // the tombstone, and its count, untouched)
  if (s->table()[idx].state == ST_TOMB) s->hdr()->tomb_count--;
  Entry& e = s->table()[idx];
  memset(&e, 0, sizeof(Entry));
  memcpy(e.id, id, kIdLen);
  e.state = ST_CREATED;
  e.offset = block + kBlockHdr;
  e.size = size;
  e.lru_prev = e.lru_next = -1;
  // pin for the creating process so the writer's buffer can't be evicted
  e.creator_pid = static_cast<uint32_t>(getpid());
  e.refs[0].pid = static_cast<int32_t>(getpid());
  e.refs[0].count = 1;
  s->hdr()->nobjects++;
  *out_off = e.offset;
  unlock(s);
  return 0;
}

// Seal a created object (makes it gettable) and drop the creator's pin.
int tps_seal(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  if (lock(s) != 0) return -EAGAIN;
  int64_t idx = table_find(s, id, false);
  if (idx < 0) { unlock(s); return -ENOENT; }
  Entry& e = s->table()[idx];
  if (e.state == ST_SEALED) { unlock(s); return 0; }
  int32_t me = static_cast<int32_t>(getpid());
  if (e.creator_pid != static_cast<uint32_t>(me)) {
    // The id was re-created by another process (task retry orphaned our
    // entry): their in-flight object is not ours to publish. Drop our
    // creation pin on the orphaned incarnation so its block can free.
    int64_t orphan = find_orphan(s, id);
    if (orphan >= 0 &&
        s->table()[orphan].creator_pid == static_cast<uint32_t>(me)) {
      drop_pin(s, orphan, me);
    }
    unlock(s);
    return 0;
  }
  e.state = ST_SEALED;
  for (int i = 0; i < kRefSlots; ++i) {
    if (e.refs[i].pid == me && e.refs[i].count > 0) {
      if (--e.refs[i].count == 0) e.refs[i].pid = 0;
      break;
    }
  }
  lru_push_front(s, idx);
  unlock(s);
  return 0;
}

// Pin + locate a sealed object. Returns 0 with *out_off/*out_size set,
// or -ENOENT.
int tps_get(void* handle, const uint8_t* id, uint64_t* out_off,
            uint64_t* out_size) {
  Store* s = static_cast<Store*>(handle);
  if (lock(s) != 0) return -EAGAIN;
  int64_t idx = table_find(s, id, false);
  if (idx < 0 || s->table()[idx].state != ST_SEALED) {
    unlock(s);
    return -ENOENT;
  }
  Entry& e = s->table()[idx];
  int32_t me = static_cast<int32_t>(getpid());
  int slot = find_ref_slot(e, me);
  if (slot < 0) { unlock(s); return -EBUSY; }  // too many live pinners
  e.refs[slot].pid = me;
  e.refs[slot].count++;
  lru_unlink(s, idx);
  lru_push_front(s, idx);
  *out_off = e.offset;
  *out_size = e.size;
  unlock(s);
  return 0;
}

// Copy a sealed object's payload into `dest` while holding the store lock
// (no pin taken; safe because delete/evict also require the lock). Fallback
// for readers that cannot get a pin slot (-EBUSY from tps_get). Returns the
// payload size, -ENOENT if absent, or -ERANGE if dest_len is too small.
int64_t tps_read(void* handle, const uint8_t* id, uint8_t* dest,
                 uint64_t dest_len) {
  Store* s = static_cast<Store*>(handle);
  if (lock(s) != 0) return -EAGAIN;
  int64_t idx = table_find(s, id, false);
  if (idx < 0 || s->table()[idx].state != ST_SEALED) {
    unlock(s);
    return -ENOENT;
  }
  Entry& e = s->table()[idx];
  if (e.size > dest_len) { unlock(s); return -ERANGE; }
  uint64_t off = e.offset;
  int64_t n = static_cast<int64_t>(e.size);
  int32_t me = static_cast<int32_t>(getpid());
  int slot = find_ref_slot(e, me);
  if (slot >= 0) {
    // pin, copy outside the lock (a multi-GB memcpy must not stall the
    // whole node), then unpin
    e.refs[slot].pid = me;
    e.refs[slot].count++;
    unlock(s);
    memcpy(dest, s->base + off, static_cast<size_t>(n));
    if (lock(s) != 0) return n;  // copied fine; pin swept later
    int64_t idx2 = table_find(s, id, false);
    if (idx2 >= 0 && s->table()[idx2].offset == off) {
      drop_pin(s, idx2, me);
    } else {
      // the id was deleted+re-created while we copied: our pin lives on
      // the orphaned incarnation (matched by payload offset), not on the
      // new entry
      int64_t orphan = find_orphan(s, id);
      if (orphan >= 0 && s->table()[orphan].offset == off) {
        drop_pin(s, orphan, me);
      }
    }
    unlock(s);
    return n;
  }
  // no slot free (the very case this fallback serves): copy under lock
  memcpy(dest, s->base + off, static_cast<size_t>(n));
  unlock(s);
  return n;
}

int tps_contains(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  if (lock(s) != 0) return 0;
  int64_t idx = table_find(s, id, false);
  int ok = idx >= 0 && s->table()[idx].state == ST_SEALED &&
           !s->table()[idx].pending_delete;
  unlock(s);
  return ok;
}

// Drop one pin held by this process. Frees the object if a delete was
// pending and this was the last pin.
int tps_release(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  if (lock(s) != 0) return -EAGAIN;
  int64_t idx = table_find(s, id, false);
  if (idx < 0) { unlock(s); return -ENOENT; }
  Entry& e = s->table()[idx];
  int32_t me = static_cast<int32_t>(getpid());
  for (int i = 0; i < kRefSlots; ++i) {
    if (e.refs[i].pid == me && e.refs[i].count > 0) {
      if (--e.refs[i].count == 0) e.refs[i].pid = 0;
      break;
    }
  }
  if (e.pending_delete && total_refs(e) == 0) drop_object(s, idx);
  maybe_rehash(s);
  unlock(s);
  return 0;
}

// Delete an object: immediately if unpinned, else deferred to the last
// release (plasma's deletion semantics).
int tps_delete(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  if (lock(s) != 0) return -EAGAIN;
  int64_t idx = table_find(s, id, false);
  if (idx < 0) { unlock(s); return -ENOENT; }
  Entry& e = s->table()[idx];
  if (total_refs(e) == 0) drop_object(s, idx);
  else e.pending_delete = 1;
  maybe_rehash(s);
  unlock(s);
  return 0;
}

// Evict up to `need` bytes of LRU unpinned sealed objects.
uint64_t tps_evict(void* handle, uint64_t need) {
  Store* s = static_cast<Store*>(handle);
  if (lock(s) != 0) return 0;
  uint64_t freed = evict_lru(s, need);
  unlock(s);
  return freed;
}

// Remove pins held by pids not in `alive` (dead-worker sweep), then apply
// any now-unblocked deferred deletes. Returns number of objects freed.
int tps_sweep(void* handle, const int32_t* alive, int n_alive) {
  Store* s = static_cast<Store*>(handle);
  if (lock(s) != 0) return 0;
  Header* h = s->hdr();
  int freed = 0;
  for (uint64_t i = 0; i < h->table_cap; ++i) {
    Entry& e = s->table()[i];
    if (e.state != ST_CREATED && e.state != ST_SEALED &&
        e.state != ST_ORPHAN) {
      continue;
    }
    for (int r = 0; r < kRefSlots; ++r) {
      if (e.refs[r].count == 0) continue;
      bool ok = false;
      for (int a = 0; a < n_alive; ++a) {
        if (alive[a] == e.refs[r].pid) { ok = true; break; }
      }
      if (!ok) { e.refs[r].pid = 0; e.refs[r].count = 0; }
    }
    if (total_refs(e) == 0 &&
        (e.pending_delete || e.state == ST_CREATED ||
         e.state == ST_ORPHAN)) {
      // dead creator never sealed it, delete was pending, or the id was
      // re-created over this entry and the last pinner is gone
      drop_object(s, static_cast<int64_t>(i));
      freed++;
    }
  }
  maybe_rehash(s);
  unlock(s);
  return freed;
}

void tps_stats(void* handle, uint64_t* capacity, uint64_t* used,
               uint64_t* nobjects, uint64_t* evicted_bytes) {
  Store* s = static_cast<Store*>(handle);
  if (lock(s) != 0) return;
  Header* h = s->hdr();
  if (capacity) *capacity = h->heap_size;
  if (used) *used = h->used_bytes;
  if (nobjects) *nobjects = h->nobjects;
  if (evicted_bytes) *evicted_bytes = h->evicted_bytes;
  unlock(s);
}

}  // extern "C"
