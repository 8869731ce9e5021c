// Native mesh I/O core of mesh_tpu_torch (a copy of mesh_tpu/native/meshio.cpp).
//
// Host-side file ingest and export: Python-level line parsing is the
// bottleneck the reference psbody loader grew a C++ path for
// (mesh/src/py_loadobj.cpp).  This library exposes a plain C ABI consumed
// through ctypes by serialization/native.py: parse once into growable
// buffers, hand Python flat arrays and a compact event log for segments,
// landmarks and mtllib lines; write PLY and OBJ byte-identical to the
// pure-Python writers.  It is host code, not a device kernel.
//
// Supported surface (parity with py_loadobj.cpp:105-189):
//   v x y z [r g b]      vt u v [w]        vn x y z
//   f a b c d...         (fan triangulation; a, a/t, a/t/n, a//n forms)
//   g <name>             #landmark <name>  mtllib <path>

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct ObjData {
  std::vector<double> v, vt, vn, vc;
  std::vector<int64_t> f, ft, fn;
  int vt_width = 2;
  // event log: lines of "g <name> <next_face_idx>", "l <name> <next_vert>",
  // "m <mtl_path>" — decoded by the Python binding
  std::string events;
  std::string error;
};

inline const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
  return p;
}

inline const char* next_token(const char* p, std::string* out) {
  p = skip_ws(p);
  const char* start = p;
  while (*p && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n') ++p;
  out->assign(start, p - start);
  return p;
}

// parse up to `max_vals` doubles; returns count parsed
inline int parse_doubles(const char* p, double* out, int max_vals) {
  int n = 0;
  char* end = nullptr;
  while (n < max_vals) {
    p = skip_ws(p);
    if (*p == '\0' || *p == '\n') break;
    double val = strtod(p, &end);
    if (end == p) break;
    out[n++] = val;
    p = end;
  }
  return n;
}

}  // namespace

extern "C" {

ObjData* obj_load(const char* path) {
  FILE* fp = fopen(path, "rb");
  auto* data = new ObjData();
  if (!fp) {
    data->error = std::string("could not open ") + path;
    return data;
  }
  // slurp the file; OBJ files are line-oriented ascii
  fseek(fp, 0, SEEK_END);
  long size = ftell(fp);
  fseek(fp, 0, SEEK_SET);
  std::string buf(size, '\0');
  size_t got = fread(&buf[0], 1, size, fp);
  fclose(fp);
  buf.resize(got);

  std::string pending_landmark;
  std::string tok;
  std::vector<int64_t> corner_v, corner_t, corner_n;

  const char* p = buf.c_str();
  const char* bufend = p + buf.size();
  while (p < bufend) {
    const char* line_end = static_cast<const char*>(memchr(p, '\n', bufend - p));
    if (!line_end) line_end = bufend;
    const char* q = skip_ws(p);
    if (q[0] == 'v' && (q[1] == ' ' || q[1] == '\t')) {
      double vals[6];
      int n = parse_doubles(q + 1, vals, 6);
      if (n >= 3) {
        data->v.insert(data->v.end(), vals, vals + 3);
        if (n == 6) data->vc.insert(data->vc.end(), vals + 3, vals + 6);
        if (!pending_landmark.empty()) {
          data->events += "l " + pending_landmark + " " +
                          std::to_string(data->v.size() / 3 - 1) + "\n";
          pending_landmark.clear();
        }
      }
    } else if (q[0] == 'v' && q[1] == 't') {
      // always store 3 slots per vt so a mid-file 2->3 component switch
      // cannot misalign the buffer; obj_copy strides by the final width
      double vals[3] = {0.0, 0.0, 0.0};
      int n = parse_doubles(q + 2, vals, 3);
      if (n >= 2) {
        if (n == 3) data->vt_width = 3;
        data->vt.insert(data->vt.end(), vals, vals + 3);
      }
    } else if (q[0] == 'v' && q[1] == 'n') {
      double vals[3];
      if (parse_doubles(q + 2, vals, 3) == 3)
        data->vn.insert(data->vn.end(), vals, vals + 3);
    } else if (q[0] == 'f' && (q[1] == ' ' || q[1] == '\t')) {
      corner_v.clear();
      corner_t.clear();
      corner_n.clear();
      const char* c = q + 1;
      while (c < line_end) {
        c = skip_ws(c);
        if (c >= line_end || *c == '\n') break;
        char* end = nullptr;
        long a = strtol(c, &end, 10);
        if (end == c) break;
        c = end;
        long t = 0, nn = 0;
        bool has_t = false, has_n = false;
        if (*c == '/') {
          ++c;
          if (*c != '/') {
            t = strtol(c, &end, 10);
            has_t = end != c;
            c = end;
          }
          if (*c == '/') {
            ++c;
            nn = strtol(c, &end, 10);
            has_n = end != c;
            c = end;
          }
        }
        corner_v.push_back(a);
        corner_t.push_back(has_t ? t : 0);
        corner_n.push_back(has_n ? nn : 0);
      }
      for (size_t i = 1; i + 1 < corner_v.size(); ++i) {
        data->f.push_back(corner_v[0] - 1);
        data->f.push_back(corner_v[i] - 1);
        data->f.push_back(corner_v[i + 1] - 1);
        if (corner_t[0] > 0) {
          data->ft.push_back(corner_t[0] - 1);
          data->ft.push_back(corner_t[i] - 1);
          data->ft.push_back(corner_t[i + 1] - 1);
        }
        if (corner_n[0] > 0) {
          data->fn.push_back(corner_n[0] - 1);
          data->fn.push_back(corner_n[i] - 1);
          data->fn.push_back(corner_n[i + 1] - 1);
        }
      }
    } else if (q[0] == 'g' && (q[1] == ' ' || q[1] == '\t')) {
      next_token(q + 1, &tok);
      data->events +=
          "g " + tok + " " + std::to_string(data->f.size() / 3) + "\n";
    } else if (strncmp(q, "#landmark", 9) == 0) {
      next_token(q + 9, &pending_landmark);
    } else if (strncmp(q, "mtllib", 6) == 0) {
      next_token(q + 6, &tok);
      data->events += "m " + tok + "\n";
    }
    p = line_end + 1;
  }
  return data;
}

void obj_free(ObjData* data) { delete data; }

const char* obj_error(ObjData* data) { return data->error.c_str(); }

const char* obj_events(ObjData* data) { return data->events.c_str(); }

void obj_counts(ObjData* data, int64_t* out) {
  out[0] = data->v.size() / 3;
  out[1] = data->vt.size() / 3;  // stored 3 slots per entry regardless of width
  out[2] = data->vn.size() / 3;
  out[3] = data->f.size() / 3;
  out[4] = data->ft.size() / 3;
  out[5] = data->fn.size() / 3;
  out[6] = data->vc.size() / 3;
  out[7] = data->vt_width;
}

void obj_copy(ObjData* data, double* v, double* vt, double* vn, double* vc,
              int64_t* f, int64_t* ft, int64_t* fn) {
  if (v) memcpy(v, data->v.data(), data->v.size() * sizeof(double));
  if (vt) {
    // emit rows of vt_width components from the 3-slot storage
    size_t rows = data->vt.size() / 3;
    for (size_t r = 0; r < rows; ++r)
      memcpy(vt + r * data->vt_width, data->vt.data() + r * 3,
             data->vt_width * sizeof(double));
  }
  if (vn) memcpy(vn, data->vn.data(), data->vn.size() * sizeof(double));
  if (vc) memcpy(vc, data->vc.data(), data->vc.size() * sizeof(double));
  if (f) memcpy(f, data->f.data(), data->f.size() * sizeof(int64_t));
  if (ft) memcpy(ft, data->ft.data(), data->ft.size() * sizeof(int64_t));
  if (fn) memcpy(fn, data->fn.data(), data->fn.size() * sizeof(int64_t));
}

}  // extern "C"

// ---------------------------------------------------------------------------
// PLY reader — native analog of the reference's plyutils.c + rply.c stack
// (mesh/src/plyutils.c:64-137 reads via per-element rply callbacks into
// Python lists; here one pass fills contiguous buffers).  Handles ascii,
// binary_little_endian and binary_big_endian, arbitrary extra elements and
// properties (skipped correctly), and fan-triangulates polygonal face rows.

namespace {

enum PlyType { T_I8, T_U8, T_I16, T_U16, T_I32, T_U32, T_F32, T_F64, T_BAD };

inline int ply_type_size(PlyType t) {
  switch (t) {
    case T_I8: case T_U8: return 1;
    case T_I16: case T_U16: return 2;
    case T_I32: case T_U32: case T_F32: return 4;
    case T_F64: return 8;
    default: return 0;
  }
}

PlyType ply_type_from(const std::string& s) {
  if (s == "char" || s == "int8") return T_I8;
  if (s == "uchar" || s == "uint8") return T_U8;
  if (s == "short" || s == "int16") return T_I16;
  if (s == "ushort" || s == "uint16") return T_U16;
  if (s == "int" || s == "int32") return T_I32;
  if (s == "uint" || s == "uint32") return T_U32;
  if (s == "float" || s == "float32") return T_F32;
  if (s == "double" || s == "float64") return T_F64;
  return T_BAD;
}

inline uint64_t load_swapped(const unsigned char* p, int size, bool swap) {
  uint64_t raw = 0;
  if (swap) {
    for (int i = 0; i < size; ++i) raw = (raw << 8) | p[i];
  } else {
    for (int i = size - 1; i >= 0; --i) raw = (raw << 8) | p[i];
  }
  return raw;
}

// read one binary scalar at p (advancing it) as double
inline double read_binary(const unsigned char*& p, PlyType t, bool swap) {
  if (!swap) {
    // fast path: file endianness matches the (little-endian) host
    switch (t) {
      case T_I8: return static_cast<int8_t>(*p++);
      case T_U8: return *p++;
      case T_I16: { int16_t x; memcpy(&x, p, 2); p += 2; return x; }
      case T_U16: { uint16_t x; memcpy(&x, p, 2); p += 2; return x; }
      case T_I32: { int32_t x; memcpy(&x, p, 4); p += 4; return x; }
      case T_U32: { uint32_t x; memcpy(&x, p, 4); p += 4; return x; }
      case T_F32: { float x; memcpy(&x, p, 4); p += 4; return x; }
      case T_F64: { double x; memcpy(&x, p, 8); p += 8; return x; }
      default: return 0.0;
    }
  }
  int size = ply_type_size(t);
  uint64_t raw = load_swapped(p, size, swap);
  p += size;
  switch (t) {
    case T_I8: return static_cast<int8_t>(raw);
    case T_U8: return static_cast<uint8_t>(raw);
    case T_I16: return static_cast<int16_t>(raw);
    case T_U16: return static_cast<uint16_t>(raw);
    case T_I32: return static_cast<int32_t>(raw);
    case T_U32: return static_cast<uint32_t>(raw);
    case T_F32: {
      uint32_t bits = static_cast<uint32_t>(raw);
      float out;
      memcpy(&out, &bits, 4);
      return out;
    }
    case T_F64: {
      double out;
      memcpy(&out, &raw, 8);
      return out;
    }
    default: return 0.0;
  }
}

struct PlyProp {
  bool is_list = false;
  PlyType count_type = T_U8, value_type = T_F32;
  std::string name;
};

struct PlyElement {
  std::string name;
  int64_t count = 0;
  std::vector<PlyProp> props;
};

struct PlyData {
  std::vector<double> pts, normals, color;
  std::vector<int64_t> tri;
  std::string error;
};

}  // namespace

namespace {

void ply_parse(const char* path, PlyData* data) {
  FILE* fp = fopen(path, "rb");
  if (!fp) {
    data->error = "Failed to open PLY file.";
    return;
  }
  fseek(fp, 0, SEEK_END);
  long size = ftell(fp);
  fseek(fp, 0, SEEK_SET);
  std::string buf(size, '\0');
  size_t got = fread(&buf[0], 1, size, fp);
  fclose(fp);
  buf.resize(got);

  // --- header ---
  size_t pos = 0;
  auto next_line = [&](std::string* line) -> bool {
    if (pos >= buf.size()) return false;
    size_t end = buf.find('\n', pos);
    if (end == std::string::npos) end = buf.size();
    size_t len = end - pos;
    while (len > 0 && (buf[pos + len - 1] == '\r')) --len;
    line->assign(buf, pos, len);
    pos = end + 1;
    return true;
  };
  std::string line;
  if (!next_line(&line) || line != "ply") {
    data->error = "Failed to open PLY file: bad magic.";
    return;
  }
  std::string fmt;
  std::vector<PlyElement> elements;
  bool header_done = false;
  while (next_line(&line)) {
    const char* q = skip_ws(line.c_str());
    std::string tok;
    const char* rest = next_token(q, &tok);
    if (tok == "format") {
      next_token(rest, &fmt);
    } else if (tok == "element") {
      PlyElement el;
      rest = next_token(rest, &el.name);
      std::string cnt;
      next_token(rest, &cnt);
      el.count = strtoll(cnt.c_str(), nullptr, 10);
      elements.push_back(el);
    } else if (tok == "property") {
      if (elements.empty()) continue;
      PlyProp prop;
      std::string t1;
      rest = next_token(rest, &t1);
      if (t1 == "list") {
        prop.is_list = true;
        std::string ct, vt;
        rest = next_token(rest, &ct);
        rest = next_token(rest, &vt);
        prop.count_type = ply_type_from(ct);
        prop.value_type = ply_type_from(vt);
      } else {
        prop.value_type = ply_type_from(t1);
      }
      next_token(rest, &prop.name);
      if (prop.value_type == T_BAD || (prop.is_list && prop.count_type == T_BAD)) {
        data->error = "Failed to open PLY file: unknown property type.";
        return;
      }
      elements.back().props.push_back(prop);
    } else if (tok == "end_header") {
      header_done = true;
      break;
    }  // comment / obj_info / blank: ignore
  }
  if (!header_done || (fmt != "ascii" && fmt != "binary_little_endian" &&
                       fmt != "binary_big_endian")) {
    data->error = "Failed to open PLY file: truncated or bad header.";
    return;
  }
  const bool is_ascii = fmt == "ascii";
  // this code targets little-endian hosts (x86/arm); swap iff file is BE
  const bool swap = fmt == "binary_big_endian";

  const unsigned char* bp =
      reinterpret_cast<const unsigned char*>(buf.data()) + pos;
  const unsigned char* bend =
      reinterpret_cast<const unsigned char*>(buf.data()) + buf.size();
  const char* ap = buf.c_str() + pos;

  // ascii scalar tokenizer; sets ascii_ok=false instead of yielding zeros
  // when the body runs out of numeric tokens (truncated/corrupt file)
  bool ascii_ok = true;
  auto ascii_value = [&]() -> double {
    char* end = nullptr;
    while (ap < buf.c_str() + buf.size() &&
           (*ap == ' ' || *ap == '\t' || *ap == '\r' || *ap == '\n'))
      ++ap;
    double out = strtod(ap, &end);
    if (end == ap) ascii_ok = false;
    ap = end;
    return out;
  };

  std::vector<double> row;
  std::vector<int64_t> poly;
  for (const auto& el : elements) {
    const bool is_vertex = el.name == "vertex";
    const bool el_is_face = el.name == "face";
    if (el.count < 0) {
      data->error = "Failed to open PLY file: bad element count.";
      return;
    }
    // per-name scalar column indices within the vertex element (property
    // order is arbitrary in the format; do not assume x,y,z adjacency)
    int col[9];
    for (int i = 0; i < 9; ++i) col[i] = -1;
    static const char* kNames[9] = {"x",  "y",  "z",   "nx",    "ny",
                                    "nz", "red", "green", "blue"};
    {
      int n_scalar = 0;
      int64_t min_row_bytes = 0;
      for (size_t i = 0; i < el.props.size(); ++i) {
        if (!el.props[i].is_list) {
          for (int k = 0; k < 9; ++k)
            if (el.props[i].name == kNames[k]) col[k] = n_scalar;
          ++n_scalar;
          min_row_bytes += ply_type_size(el.props[i].value_type);
        } else {
          min_row_bytes += ply_type_size(el.props[i].count_type);
        }
      }
      // sanity-bound the declared count against the remaining bytes before
      // any reserve(), so a malformed header cannot drive allocation
      if (!is_ascii && min_row_bytes > 0 &&
          el.count > (bend - bp) / min_row_bytes + 1) {
        data->error = "Failed to open PLY file: truncated body.";
        return;
      }
      if (is_ascii && el.count > static_cast<int64_t>(buf.size())) {
        data->error = "Failed to open PLY file: truncated body.";
        return;
      }
    }
    const bool has_xyz = col[0] >= 0 && col[1] >= 0 && col[2] >= 0;
    const bool has_n = col[3] >= 0 && col[4] >= 0 && col[5] >= 0;
    const bool has_c = col[6] >= 0 && col[7] >= 0 && col[8] >= 0;
    if (is_vertex) {
      if (has_xyz) data->pts.reserve(el.count * 3);
      if (has_n) data->normals.reserve(el.count * 3);
      if (has_c) data->color.reserve(el.count * 3);
    }
    for (int64_t r = 0; r < el.count; ++r) {
      row.clear();
      for (const auto& prop : el.props) {
        // only the index list yields triangles; other face lists (e.g. a
        // texcoord list) are consumed but ignored
        const bool is_face =
            el_is_face && (prop.name == "vertex_indices" ||
                           prop.name == "vertex_index");
        if (!prop.is_list) {
          double val;
          if (is_ascii) {
            val = ascii_value();
            if (!ascii_ok) {
              data->error = "Failed to open PLY file: truncated body.";
              return;
            }
          } else {
            if (bp + ply_type_size(prop.value_type) > bend) {
              data->error = "Failed to open PLY file: truncated body.";
              return;
            }
            val = read_binary(bp, prop.value_type, swap);
          }
          if (is_vertex) row.push_back(val);
        } else {
          int64_t n;
          if (is_ascii) {
            n = static_cast<int64_t>(ascii_value());
            if (!ascii_ok) {
              data->error = "Failed to open PLY file: truncated body.";
              return;
            }
          } else {
            if (bp + ply_type_size(prop.count_type) > bend) {
              data->error = "Failed to open PLY file: truncated body.";
              return;
            }
            n = static_cast<int64_t>(read_binary(bp, prop.count_type, swap));
          }
          if (n < 0 || (!is_ascii && n > bend - bp)) {
            data->error = "Failed to open PLY file: truncated body.";
            return;
          }
          poly.clear();
          for (int64_t i = 0; i < n; ++i) {
            double val;
            if (is_ascii) {
              val = ascii_value();
              if (!ascii_ok) {
                data->error = "Failed to open PLY file: truncated body.";
                return;
              }
            } else {
              if (bp + ply_type_size(prop.value_type) > bend) {
                data->error = "Failed to open PLY file: truncated body.";
                return;
              }
              val = read_binary(bp, prop.value_type, swap);
            }
            if (is_face) poly.push_back(static_cast<int64_t>(val));
          }
          if (is_face) {
            for (size_t i = 1; i + 1 < poly.size(); ++i) {
              data->tri.push_back(poly[0]);
              data->tri.push_back(poly[i]);
              data->tri.push_back(poly[i + 1]);
            }
          }
        }
      }
      if (is_vertex) {
        const int nrow = static_cast<int>(row.size());
        if (has_xyz && col[0] < nrow && col[1] < nrow && col[2] < nrow) {
          data->pts.push_back(row[col[0]]);
          data->pts.push_back(row[col[1]]);
          data->pts.push_back(row[col[2]]);
        }
        if (has_n && col[3] < nrow && col[4] < nrow && col[5] < nrow) {
          data->normals.push_back(row[col[3]]);
          data->normals.push_back(row[col[4]]);
          data->normals.push_back(row[col[5]]);
        }
        if (has_c && col[6] < nrow && col[7] < nrow && col[8] < nrow) {
          data->color.push_back(row[col[6]]);
          data->color.push_back(row[col[7]]);
          data->color.push_back(row[col[8]]);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

PlyData* ply_load(const char* path) {
  // exceptions (bad_alloc/length_error from malformed headers) must not
  // cross the C ABI into ctypes; surface them as the standard error string
  auto* data = new PlyData();
  try {
    ply_parse(path, data);
  } catch (const std::exception& e) {
    data->pts.clear();
    data->tri.clear();
    data->normals.clear();
    data->color.clear();
    data->error = std::string("Failed to open PLY file: ") + e.what();
  }
  return data;
}

void ply_free(PlyData* data) { delete data; }

const char* ply_error(PlyData* data) { return data->error.c_str(); }

void ply_counts(PlyData* data, int64_t* out) {
  out[0] = data->pts.size() / 3;
  out[1] = data->tri.size() / 3;
  out[2] = data->normals.size() / 3;
  out[3] = data->color.size() / 3;
}

void ply_copy(PlyData* data, double* pts, int64_t* tri, double* normals,
              double* color) {
  if (pts) memcpy(pts, data->pts.data(), data->pts.size() * sizeof(double));
  if (tri) memcpy(tri, data->tri.data(), data->tri.size() * sizeof(int64_t));
  if (normals)
    memcpy(normals, data->normals.data(), data->normals.size() * sizeof(double));
  if (color)
    memcpy(color, data->color.data(), data->color.size() * sizeof(double));
}

}  // extern "C"

// ---------------------------------------------------------------------------
// PLY writer — byte-identical to the layout the pure-Python writer emits
// (serialization/ply.py:write_ply_data), which itself matches the rply
// output of the reference (mesh/src/plyutils.c:140-246): float32 x/y/z
// (+ float32 nx/ny/nz, uchar rgb), uchar-count int32-index face lists,
// ascii values in printf "%g" with a trailing space per value.

namespace {

thread_local std::string g_write_error;

inline void put_swapped4(std::string* out, const void* p) {
  const unsigned char* b = static_cast<const unsigned char*>(p);
  char sw[4] = {static_cast<char>(b[3]), static_cast<char>(b[2]),
                static_cast<char>(b[1]), static_cast<char>(b[0])};
  out->append(sw, 4);
}

inline void put_f32(std::string* out, float x, bool swap) {
  if (swap) {
    put_swapped4(out, &x);
  } else {
    out->append(reinterpret_cast<const char*>(&x), 4);
  }
}

inline void put_i32(std::string* out, int32_t x, bool swap) {
  if (swap) {
    put_swapped4(out, &x);
  } else {
    out->append(reinterpret_cast<const char*>(&x), 4);
  }
}

}  // namespace

extern "C" {

// mode: 0 = ascii, 1 = binary little-endian, 2 = binary big-endian.
// v: n_v x 3 doubles (stored as float32); vn: n_v x 3 doubles or NULL;
// vc: n_v x 3 uchars or NULL; f: n_f x 3 int32 or NULL;
// comments: newline-separated string or NULL.
// Returns NULL on success, an error message otherwise.
const char* ply_write(const char* path, int64_t n_v, const double* v,
                      const double* vn, const unsigned char* vc, int64_t n_f,
                      const int32_t* f, int mode, const char* comments) {
  const bool ascii_mode = mode == 0;
  const bool big_endian = mode == 2;
  std::string out;
  out.reserve(static_cast<size_t>(n_v) * (ascii_mode ? 32 : 15) +
              static_cast<size_t>(n_f) * (ascii_mode ? 16 : 13) + 512);

  out += "ply\nformat ";
  out += ascii_mode ? "ascii"
                    : (big_endian ? "binary_big_endian" : "binary_little_endian");
  out += " 1.0\n";
  if (comments) {
    // newline-SEPARATED blob: n separators mean n+1 comment lines, and
    // empty segments still emit "comment " (matching the Python writer)
    const char* p = comments;
    while (true) {
      const char* nl = strchr(p, '\n');
      size_t len = nl ? static_cast<size_t>(nl - p) : strlen(p);
      out += "comment ";
      out.append(p, len);
      out += "\n";
      if (!nl) break;
      p = nl + 1;
    }
  }
  char line[128];
  snprintf(line, sizeof(line), "element vertex %lld\n",
           static_cast<long long>(n_v));
  out += line;
  out += "property float x\nproperty float y\nproperty float z\n";
  if (vn) out += "property float nx\nproperty float ny\nproperty float nz\n";
  if (vc) out += "property uchar red\nproperty uchar green\nproperty uchar blue\n";
  snprintf(line, sizeof(line), "element face %lld\n",
           static_cast<long long>(n_f));
  out += line;
  out += "property list uchar int vertex_indices\nend_header\n";

  if (ascii_mode) {
    char buf[64];
    for (int64_t i = 0; i < n_v; ++i) {
      for (int k = 0; k < 3; ++k) {
        // match Python "%g" % float32(x): double-ized float32 through %g
        snprintf(buf, sizeof(buf), "%g ",
                 static_cast<double>(static_cast<float>(v[i * 3 + k])));
        out += buf;
      }
      if (vn) {
        for (int k = 0; k < 3; ++k) {
          snprintf(buf, sizeof(buf), "%g ",
                   static_cast<double>(static_cast<float>(vn[i * 3 + k])));
          out += buf;
        }
      }
      if (vc) {
        for (int k = 0; k < 3; ++k) {
          snprintf(buf, sizeof(buf), "%d ", vc[i * 3 + k]);
          out += buf;
        }
      }
      // each value above carries its separator, so the line already ends
      // with the trailing space the Python writer emits
      out += "\n";
    }
    for (int64_t i = 0; i < n_f; ++i) {
      snprintf(buf, sizeof(buf), "3 %d %d %d \n", f[i * 3], f[i * 3 + 1],
               f[i * 3 + 2]);
      out += buf;
    }
  } else {
    for (int64_t i = 0; i < n_v; ++i) {
      for (int k = 0; k < 3; ++k)
        put_f32(&out, static_cast<float>(v[i * 3 + k]), big_endian);
      if (vn)
        for (int k = 0; k < 3; ++k)
          put_f32(&out, static_cast<float>(vn[i * 3 + k]), big_endian);
      if (vc)
        for (int k = 0; k < 3; ++k) out += static_cast<char>(vc[i * 3 + k]);
    }
    for (int64_t i = 0; i < n_f; ++i) {
      out += static_cast<char>(3);
      for (int k = 0; k < 3; ++k) put_i32(&out, f[i * 3 + k], big_endian);
    }
  }

  FILE* fp = fopen(path, "wb");
  if (!fp) {
    g_write_error = std::string("could not open for writing: ") + path;
    return g_write_error.c_str();
  }
  size_t written = fwrite(out.data(), 1, out.size(), fp);
  int rc = fclose(fp);
  if (written != out.size() || rc != 0) {
    g_write_error = std::string("short write: ") + path;
    return g_write_error.c_str();
  }
  return nullptr;
}

// OBJ writer — byte-identical to the text layout of the pure-Python writer
// (serialization/obj.py:write_obj_data), which preserves the reference's
// "%f" floats and face-line spacing quirks (reference serialization.py:
// 134-196).  The header blob (comments + mtllib, O(bytes)) is pre-rendered
// by the Python caller; the grouped/segmented face layout stays Python.
//
// v: n_v x 3 doubles; vn: n_vn x 3 or NULL; vt: n_vt x vt_cols (2|3) or
// NULL; f/ft/fn: n_f x 3 int64 or NULL (ft and fn together select the
// a/b/c form; fn alone the a//b form).  flip reverses each face's corner
// order.  Returns NULL on success, an error message otherwise.
const char* obj_write(const char* path, const char* header,
                      int64_t n_v, const double* v,
                      int64_t n_vn, const double* vn,
                      int64_t n_vt, const double* vt, int vt_cols,
                      int64_t n_f, const int64_t* f,
                      const int64_t* ft, const int64_t* fn, int flip) {
  std::string out;
  out.reserve(static_cast<size_t>(n_v) * 40 +
              static_cast<size_t>(n_f) * 40 + 512);
  if (header) out += header;
  // %f of any finite double is at most ~317 chars (DBL_MAX: 309 integer
  // digits + '.' + 6 decimals), so 1024 covers the worst 3-double vertex
  // line and every face line (9 int64s); the length check keeps a
  // hypothetical overflow from silently gluing lines together
  char buf[1024];
  auto append = [&out, &buf](int len) {
    out.append(buf, std::min(static_cast<size_t>(len), sizeof(buf) - 1));
  };
  for (int64_t i = 0; i < n_v; ++i)
    append(snprintf(buf, sizeof(buf), "v %f %f %f\n", v[3 * i],
                    v[3 * i + 1], v[3 * i + 2]));
  for (int64_t i = 0; i < n_vn; ++i)
    append(snprintf(buf, sizeof(buf), "vn %f %f %f\n", vn[3 * i],
                    vn[3 * i + 1], vn[3 * i + 2]));
  for (int64_t i = 0; i < n_vt; ++i) {
    if (vt_cols == 3)
      append(snprintf(buf, sizeof(buf), "vt %f %f %f\n", vt[3 * i],
                      vt[3 * i + 1], vt[3 * i + 2]));
    else
      append(snprintf(buf, sizeof(buf), "vt %f %f\n", vt[2 * i],
                      vt[2 * i + 1]));
  }
  int idx[3] = {0, 1, 2};
  if (flip) {
    idx[0] = 2;
    idx[2] = 0;
  }
  for (int64_t i = 0; i < n_f; ++i) {
    const int64_t* fv = f + 3 * i;
    const long long a = fv[idx[0]] + 1;
    const long long b = fv[idx[1]] + 1;
    const long long c = fv[idx[2]] + 1;
    if (ft) {
      const int64_t* tv = ft + 3 * i;
      const int64_t* nv = fn + 3 * i;
      append(snprintf(buf, sizeof(buf),
                      "f %lld/%lld/%lld %lld/%lld/%lld  %lld/%lld/%lld\n",
                      a, static_cast<long long>(tv[idx[0]] + 1),
                      static_cast<long long>(nv[idx[0]] + 1),
                      b, static_cast<long long>(tv[idx[1]] + 1),
                      static_cast<long long>(nv[idx[1]] + 1),
                      c, static_cast<long long>(tv[idx[2]] + 1),
                      static_cast<long long>(nv[idx[2]] + 1)));
    } else if (fn) {
      const int64_t* nv = fn + 3 * i;
      append(snprintf(buf, sizeof(buf),
                      "f %lld//%lld %lld//%lld  %lld//%lld\n",
                      a, static_cast<long long>(nv[idx[0]] + 1),
                      b, static_cast<long long>(nv[idx[1]] + 1),
                      c, static_cast<long long>(nv[idx[2]] + 1)));
    } else {
      append(snprintf(buf, sizeof(buf), "f %lld %lld %lld\n", a, b, c));
    }
  }
  FILE* fp = fopen(path, "wb");
  if (!fp) {
    g_write_error = std::string("could not open for writing: ") + path;
    return g_write_error.c_str();
  }
  size_t written = fwrite(out.data(), 1, out.size(), fp);
  int rc = fclose(fp);
  if (written != out.size() || rc != 0) {
    g_write_error = std::string("short write: ") + path;
    return g_write_error.c_str();
  }
  return nullptr;
}

}  // extern "C"
