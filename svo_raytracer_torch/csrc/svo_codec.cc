// Native .svo codec — import/export between the reference byte format
// and the SoA node table (the port's copy of runtime/svo_codec.cc).
//
// The reference serializes in Java (Octree.java:974-1012).  Here the codec
// is C++ with a plain C interface, compiled with the host C++ compiler at
// first use and loaded with ctypes by svo_raytracer_torch/runtime/native.py.
// core/svo_format.py holds the same codec in Python, its plain version;
// tests/test_torch_svo_io.py holds the two equal both ways.
//
// Format (see core/svo_format.py for the full layout notes):
//   branch (tag 0), 7 B: value | child-pointer int32 BE relative to own
//     address | leaf mask int16 BE
//   surface leaf (tag 1), 3 B: value | packed normal (little-endian!)
//   subdividable leaf (tag 2), 7 B: value + 6 padding bytes
//   non-surface leaf (tag 3), 1 B: value

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int TAG_BRANCH = 0;
constexpr int TAG_SURFACE = 1;
constexpr int TAG_SUBDIV = 2;
constexpr int TAG_NONSURF = 3;

constexpr int64_t kTagSize[4] = {7, 3, 7, 1};

inline int32_t read_i32_be(const uint8_t* p) {
  return static_cast<int32_t>((uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
                              (uint32_t(p[2]) << 8) | uint32_t(p[3]));
}

inline uint16_t read_u16_be(const uint8_t* p) {
  return static_cast<uint16_t>((uint16_t(p[0]) << 8) | p[1]);
}

inline uint16_t read_u16_le(const uint8_t* p) {
  return static_cast<uint16_t>(uint16_t(p[0]) | (uint16_t(p[1]) << 8));
}

inline void write_i32_be(uint8_t* p, int32_t v) {
  p[0] = uint8_t(uint32_t(v) >> 24);
  p[1] = uint8_t(uint32_t(v) >> 16);
  p[2] = uint8_t(uint32_t(v) >> 8);
  p[3] = uint8_t(uint32_t(v));
}

inline void write_u16_be(uint8_t* p, uint16_t v) {
  p[0] = uint8_t(v >> 8);
  p[1] = uint8_t(v);
}

}  // namespace

extern "C" {

// Parse a reference-format buffer into SoA arrays (pre-allocated by the
// caller with capacity slots).  Returns the node count, or -1 on overflow /
// -2 on malformed input (out-of-range pointers).
//
// Slot layout matches the Python importer: root at 0, slots 1..7 reserved,
// children allocated 8 contiguous slots per branch in DFS order.
int64_t svo_import(const uint8_t* data, int64_t len, int32_t* child,
                   int32_t* mask, int32_t* value, int32_t* normal,
                   int64_t capacity) {
  if (len < 7 || capacity < 8) return -2;
  std::memset(child, 0, sizeof(int32_t) * capacity);
  std::memset(mask, 0, sizeof(int32_t) * capacity);
  std::memset(value, 0, sizeof(int32_t) * capacity);
  std::memset(normal, 0, sizeof(int32_t) * capacity);

  struct Item {
    int64_t addr;
    int64_t slot;
    int tag;
  };
  std::vector<Item> stack;
  stack.reserve(1024);

  int64_t n = 8;
  value[0] = data[0];
  stack.push_back({0, 0, TAG_BRANCH});

  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    if (it.tag == TAG_SURFACE) {
      if (it.addr + 3 > len) return -2;
      normal[it.slot] = read_u16_le(data + it.addr + 1);
      continue;
    }
    if (it.tag == TAG_NONSURF) continue;
    // branch or subdividable: 7-byte record
    if (it.addr + 7 > len) return -2;
    int32_t cp_rel = read_i32_be(data + it.addr + 1);
    uint16_t m = read_u16_be(data + it.addr + 5);
    mask[it.slot] = m;
    if (it.tag == TAG_SUBDIV || cp_rel == 0) continue;

    int64_t base = n;
    n += 8;
    if (n > capacity) return -1;
    child[it.slot] = static_cast<int32_t>(base);
    int64_t ca = it.addr + cp_rel;
    for (int k = 0; k < 8; ++k) {
      int ctag = (m >> (2 * k)) & 3;
      if (ca < 0 || ca >= len) return -2;
      value[base + k] = data[ca];
      stack.push_back({ca, base + k, ctag});
      ca += kTagSize[ctag];
    }
  }
  return n;
}

// Serialize SoA arrays to the reference byte format in BFS order (the same
// canonical order as the Python exporter).  Two-phase; returns the byte
// length, or -1 if out_capacity is too small (call with out=nullptr,
// out_capacity=0 to size).
int64_t svo_export(const int32_t* child, const int32_t* mask,
                   const int32_t* value, const int32_t* normal,
                   int64_t n_nodes, uint8_t* out, int64_t out_capacity) {
  // BFS over the graph; per visited node record (slot, addr, tag).
  std::vector<int64_t> order_slot;
  std::vector<int64_t> order_addr;
  std::vector<uint8_t> order_tag;
  std::vector<int64_t> addr_of(n_nodes, -1);
  order_slot.reserve(n_nodes);
  order_addr.reserve(n_nodes);
  order_tag.reserve(n_nodes);

  int64_t offset = 7;
  order_slot.push_back(0);
  order_addr.push_back(0);
  order_tag.push_back(TAG_BRANCH);
  addr_of[0] = 0;

  for (size_t qi = 0; qi < order_slot.size(); ++qi) {
    int64_t p = order_slot[qi];
    if (order_tag[qi] != TAG_BRANCH) continue;
    int64_t base = child[p];
    if (base == 0) continue;
    uint16_t m = static_cast<uint16_t>(mask[p]);
    for (int k = 0; k < 8; ++k) {
      int64_t ci = base + k;
      if (ci < 0 || ci >= n_nodes) return -2;
      int tag = (m >> (2 * k)) & 3;
      addr_of[ci] = offset;
      order_slot.push_back(ci);
      order_addr.push_back(offset);
      order_tag.push_back(static_cast<uint8_t>(tag));
      offset += kTagSize[tag];
    }
  }

  if (out == nullptr) return offset;
  if (offset > out_capacity) return -1;
  std::memset(out, 0, offset);

  for (size_t qi = 0; qi < order_slot.size(); ++qi) {
    int64_t ci = order_slot[qi];
    int64_t a = order_addr[qi];
    int tag = order_tag[qi];
    out[a] = static_cast<uint8_t>(value[ci] & 0xFF);
    if (tag == TAG_SURFACE) {
      uint16_t raw = static_cast<uint16_t>(normal[ci]);
      out[a + 1] = uint8_t(raw & 0xFF);  // little-endian normal
      out[a + 2] = uint8_t(raw >> 8);
    } else if (tag == TAG_BRANCH || tag == TAG_SUBDIV) {
      int64_t base = child[ci];
      int32_t cp_rel = 0;
      if (tag == TAG_BRANCH && base != 0) {
        cp_rel = static_cast<int32_t>(addr_of[base] - a);
      }
      write_i32_be(out + a + 1, cp_rel);
      write_u16_be(out + a + 5, static_cast<uint16_t>(mask[ci] & 0xFFFF));
    }
  }
  return offset;
}

}  // extern "C"
