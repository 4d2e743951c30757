// Robot-side policy runner: loads the framework's .onnx actor and runs the
// MLP forward pass with zero dependencies (no onnxruntime, no protobuf lib).
//
// The reference deploys its exported ONNX policy through onnxruntime
// (reference scripts/simulate_trajectory.py:45-59); on the real robot that
// is a C++ inference stack.  This is the TPU-native framework's equivalent:
// a self-contained C++ decoder for the opset-13 Gemm/activation subset that
// export/onnx_writer.py emits (and torch's exporter emits for nn.Linear
// MLPs), plus a cache-friendly forward pass sized for 50 Hz-1 kHz control
// loops on an embedded CPU.
//
// Exposed as a plain C ABI (ctypes-friendly, like trajectory_log.cpp):
//   pr_load(path) -> handle (0 on failure)
//   pr_obs_dim/pr_act_dim(handle)
//   pr_run(handle, obs[batch*obs_dim], out[batch*act_dim], batch)
//   pr_free(handle)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Layer {
  int in = 0, out = 0;
  std::vector<float> w;  // (out, in) row-major — transB=1 storage order
  std::vector<float> b;  // (out,)
};

enum class Act { kLinear, kElu, kRelu, kTanh, kSelu };

struct Policy {
  std::vector<Layer> layers;
  Act act = Act::kElu;
  std::vector<float> scratch_a, scratch_b;
};

// ---------------------------------------------------------------- protobuf
struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
};

bool ReadVarint(Cursor& c, uint64_t* v) {
  *v = 0;
  int shift = 0;
  while (c.p < c.end) {
    uint8_t b = *c.p++;
    *v |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) return true;
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

// Returns field number in *field, wire type in *wire; for LEN fields sets
// *sub to the payload and advances past it; varint payloads in *v.
bool ReadField(Cursor& c, uint32_t* field, uint32_t* wire, Cursor* sub,
               uint64_t* v) {
  uint64_t key;
  if (!ReadVarint(c, &key)) return false;
  *field = static_cast<uint32_t>(key >> 3);
  *wire = static_cast<uint32_t>(key & 7);
  switch (*wire) {
    case 0:
      return ReadVarint(c, v);
    case 2: {
      uint64_t len;
      if (!ReadVarint(c, &len) || c.p + len > c.end) return false;
      sub->p = c.p;
      sub->end = c.p + len;
      c.p += len;
      return true;
    }
    case 5:
      if (c.p + 4 > c.end) return false;
      c.p += 4;
      return true;
    case 1:
      if (c.p + 8 > c.end) return false;
      c.p += 8;
      return true;
    default:
      return false;
  }
}

struct Tensor {
  std::string name;
  std::vector<int64_t> dims;
  std::vector<float> data;
};

bool ParseTensor(Cursor c, Tensor* t) {
  uint32_t f, w;
  uint64_t v;
  Cursor sub;
  while (c.p < c.end) {
    if (!ReadField(c, &f, &w, &sub, &v)) return false;
    if (f == 1 && w == 0) t->dims.push_back(static_cast<int64_t>(v));
    else if (f == 8 && w == 2)
      t->name.assign(reinterpret_cast<const char*>(sub.p), sub.end - sub.p);
    else if (f == 9 && w == 2) {
      size_t n = (sub.end - sub.p) / 4;
      t->data.resize(n);
      std::memcpy(t->data.data(), sub.p, n * 4);
    }
  }
  return true;
}

struct Node {
  std::string op;
  std::vector<std::string> inputs;
};

bool ParseNode(Cursor c, Node* n) {
  uint32_t f, w;
  uint64_t v;
  Cursor sub;
  while (c.p < c.end) {
    if (!ReadField(c, &f, &w, &sub, &v)) return false;
    if (f == 1 && w == 2)
      n->inputs.emplace_back(reinterpret_cast<const char*>(sub.p),
                             sub.end - sub.p);
    else if (f == 4 && w == 2)
      n->op.assign(reinterpret_cast<const char*>(sub.p), sub.end - sub.p);
  }
  return true;
}

Policy* ParseModel(const uint8_t* data, size_t size) {
  Cursor c{data, data + size};
  Cursor graph{nullptr, nullptr};
  uint32_t f, w;
  uint64_t v;
  Cursor sub;
  while (c.p < c.end) {
    if (!ReadField(c, &f, &w, &sub, &v)) return nullptr;
    if (f == 7 && w == 2) graph = sub;
  }
  if (!graph.p) return nullptr;

  std::vector<Tensor> tensors;
  std::vector<Node> nodes;
  c = graph;
  while (c.p < c.end) {
    if (!ReadField(c, &f, &w, &sub, &v)) return nullptr;
    if (f == 5 && w == 2) {
      Tensor t;
      if (!ParseTensor(sub, &t)) return nullptr;
      tensors.push_back(std::move(t));
    } else if (f == 1 && w == 2) {
      Node n;
      if (!ParseNode(sub, &n)) return nullptr;
      nodes.push_back(std::move(n));
    }
  }

  auto find = [&](const std::string& name) -> Tensor* {
    for (auto& t : tensors)
      if (t.name == name) return &t;
    return nullptr;
  };

  auto* pol = new Policy();
  for (const auto& n : nodes) {
    if (n.op == "Gemm") {
      if (n.inputs.size() < 3) { delete pol; return nullptr; }
      Tensor* wt = find(n.inputs[1]);
      Tensor* bt = find(n.inputs[2]);
      if (!wt || !bt || wt->dims.size() != 2) { delete pol; return nullptr; }
      Layer l;
      l.out = static_cast<int>(wt->dims[0]);  // transB=1: stored (out, in)
      l.in = static_cast<int>(wt->dims[1]);
      l.w = wt->data;
      l.b = bt->data;
      pol->layers.push_back(std::move(l));
    } else if (n.op == "Elu") {
      pol->act = Act::kElu;
    } else if (n.op == "Relu") {
      pol->act = Act::kRelu;
    } else if (n.op == "Tanh") {
      pol->act = Act::kTanh;
    } else if (n.op == "Selu") {
      pol->act = Act::kSelu;
    }
  }
  if (pol->layers.empty()) { delete pol; return nullptr; }
  int widest = 0;
  for (const auto& l : pol->layers) {
    if (l.in > widest) widest = l.in;
    if (l.out > widest) widest = l.out;
  }
  pol->scratch_a.resize(widest);
  pol->scratch_b.resize(widest);
  return pol;
}

inline float Activate(float x, Act a) {
  switch (a) {
    case Act::kElu: return x > 0.f ? x : std::expm1(x);
    case Act::kRelu: return x > 0.f ? x : 0.f;
    case Act::kTanh: return std::tanh(x);
    case Act::kSelu: {
      constexpr float kA = 1.6732632f, kL = 1.0507010f;
      return kL * (x > 0.f ? x : kA * std::expm1(x));
    }
    default: return x;
  }
}

}  // namespace

extern "C" {

void* pr_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(size > 0 ? static_cast<size_t>(size) : 0);
  size_t rd = buf.empty() ? 0 : std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  if (rd != buf.size()) return nullptr;
  return ParseModel(buf.data(), buf.size());
}

int pr_obs_dim(void* h) {
  auto* p = static_cast<Policy*>(h);
  return p && !p->layers.empty() ? p->layers.front().in : -1;
}

int pr_act_dim(void* h) {
  auto* p = static_cast<Policy*>(h);
  return p && !p->layers.empty() ? p->layers.back().out : -1;
}

int pr_num_layers(void* h) {
  auto* p = static_cast<Policy*>(h);
  return p ? static_cast<int>(p->layers.size()) : -1;
}

// obs: batch x obs_dim row-major; out: batch x act_dim.  Returns 0 on ok.
int pr_run(void* h, const float* obs, float* out, int batch) {
  auto* p = static_cast<Policy*>(h);
  if (!p || batch <= 0) return 1;
  const int obs_dim = p->layers.front().in;
  const int act_dim = p->layers.back().out;
  for (int bi = 0; bi < batch; ++bi) {
    const float* x = obs + static_cast<size_t>(bi) * obs_dim;
    float* cur = p->scratch_a.data();
    float* nxt = p->scratch_b.data();
    std::memcpy(cur, x, sizeof(float) * obs_dim);
    for (size_t li = 0; li < p->layers.size(); ++li) {
      const Layer& l = p->layers[li];
      const bool last = li + 1 == p->layers.size();
      for (int o = 0; o < l.out; ++o) {
        const float* wr = l.w.data() + static_cast<size_t>(o) * l.in;
        float acc = l.b[o];
        for (int i = 0; i < l.in; ++i) acc += wr[i] * cur[i];
        nxt[o] = last ? acc : Activate(acc, p->act);
      }
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    std::memcpy(out + static_cast<size_t>(bi) * act_dim, cur,
                sizeof(float) * act_dim);
  }
  return 0;
}

void pr_free(void* h) { delete static_cast<Policy*>(h); }

}  // extern "C"
