// Native ingest for Waymo TFRecord segments (C++, zlib).
//
// The reference decodes TFRecords with TensorFlow + generated protobuf
// classes (lib/dataloader/waymo_loader/__init__.py:1-33); the Python
// fallback here (data/proto_wire.py) is wire-compatible but slow on real
// segments (a Waymo frame is ~100 MB and Python walks every field).  This
// extension walks the protobuf wire format in C++ and zlib-inflates the
// TOP-lidar range images, exposed to Python through ctypes
// (lidar_rt_tpu_torch/native/__init__.py), with the pure-Python path as a
// fallback when no compiler is available.
//
// Wire schema (public Waymo Open Dataset protos — field numbers in
// data/waymo.py): Frame{context=1, pose=3, lasers=5, laser_labels=6}, etc.
//
// Build: g++ -O2 -shared -fPIC -o <pkg>/_build/ingest_<hash>.so ingest.cpp -lz
// (done at first use by lidar_rt_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

struct Slice {
  const uint8_t* p;
  size_t len;
};

// ---- protobuf wire primitives ----
bool read_varint(Slice& s, uint64_t* out) {
  uint64_t r = 0;
  int shift = 0;
  while (s.len > 0) {
    uint8_t b = *s.p;
    s.p++;
    s.len--;
    r |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = r;
      return true;
    }
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

// Visit each field of a message; returns false on malformed input.
template <typename F>
bool for_fields(Slice msg, F&& visit) {
  while (msg.len > 0) {
    uint64_t tag;
    if (!read_varint(msg, &tag)) return false;
    uint32_t field = (uint32_t)(tag >> 3);
    uint32_t wt = (uint32_t)(tag & 7);
    Slice val{nullptr, 0};
    uint64_t ival = 0;
    switch (wt) {
      case 0:  // varint
        if (!read_varint(msg, &ival)) return false;
        break;
      case 1:  // fixed64
        if (msg.len < 8) return false;
        val = {msg.p, 8};
        msg.p += 8;
        msg.len -= 8;
        break;
      case 2: {  // length-delimited
        uint64_t ln;
        if (!read_varint(msg, &ln) || ln > msg.len) return false;
        val = {msg.p, (size_t)ln};
        msg.p += ln;
        msg.len -= ln;
        break;
      }
      case 5:  // fixed32
        if (msg.len < 4) return false;
        val = {msg.p, 4};
        msg.p += 4;
        msg.len -= 4;
        break;
      default:
        return false;
    }
    visit(field, wt, val, ival);
  }
  return true;
}

double as_double(Slice s) {
  double d = 0;
  if (s.len >= 8) std::memcpy(&d, s.p, 8);
  return d;
}

// repeated double: packed blob or single fixed64
void collect_doubles(Slice v, uint32_t wt, std::vector<double>* out) {
  if (wt == 1) {
    out->push_back(as_double(v));
  } else if (wt == 2) {
    for (size_t i = 0; i + 8 <= v.len; i += 8) {
      double d;
      std::memcpy(&d, v.p + i, 8);
      out->push_back(d);
    }
  }
}

// Field numbers (public Waymo Open Dataset schema).
enum {
  F_FRAME_CONTEXT = 1,
  F_FRAME_POSE = 3,
  F_FRAME_LASERS = 5,
  F_FRAME_LASER_LABELS = 6,
  F_CONTEXT_LASER_CALIBRATIONS = 3,
  F_CALIB_NAME = 1,
  F_CALIB_BEAMS = 2,
  F_CALIB_BEAM_MIN = 3,
  F_CALIB_BEAM_MAX = 4,
  F_CALIB_EXTRINSIC = 5,
  F_TRANSFORM = 1,
  F_LASER_NAME = 1,
  F_LASER_RET1 = 2,
  F_LASER_RET2 = 3,
  F_RI_COMPRESSED = 2,
  F_MATRIX_DATA = 1,
  F_MATRIX_SHAPE = 2,
  F_SHAPE_DIMS = 1,
  F_LABEL_BOX = 1,
  F_LABEL_TYPE = 3,
  F_LABEL_ID = 4,
  TOP_LIDAR = 1,
};

bool inflate_all(Slice z, std::vector<uint8_t>* out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  out->resize(z.len * 8 + 4096);
  zs.next_in = const_cast<Bytef*>(z.p);
  zs.avail_in = (uInt)z.len;
  int ret;
  size_t written = 0;
  do {
    if (written == out->size()) out->resize(out->size() * 2);
    zs.next_out = out->data() + written;
    zs.avail_out = (uInt)(out->size() - written);
    ret = inflate(&zs, Z_NO_FLUSH);
    written = out->size() - zs.avail_out;
    if (ret == Z_STREAM_ERROR || ret == Z_DATA_ERROR || ret == Z_MEM_ERROR) {
      inflateEnd(&zs);
      return false;
    }
  } while (ret != Z_STREAM_END);
  out->resize(written);
  inflateEnd(&zs);
  return true;
}

// MatrixFloat -> float data + dims
bool decode_matrix(Slice z, std::vector<float>* data,
                   std::vector<int64_t>* dims) {
  std::vector<uint8_t> raw;
  if (!inflate_all(z, &raw)) return false;
  Slice m{raw.data(), raw.size()};
  return for_fields(m, [&](uint32_t f, uint32_t wt, Slice v, uint64_t iv) {
    if (f == F_MATRIX_DATA && wt == 2) {
      size_t n = v.len / 4;
      size_t base = data->size();
      data->resize(base + n);
      std::memcpy(data->data() + base, v.p, n * 4);
    } else if (f == F_MATRIX_DATA && wt == 5) {
      float fv;
      std::memcpy(&fv, v.p, 4);
      data->push_back(fv);
    } else if (f == F_MATRIX_SHAPE && wt == 2) {
      for_fields(v, [&](uint32_t f2, uint32_t wt2, Slice v2, uint64_t iv2) {
        if (f2 == F_SHAPE_DIMS) {
          if (wt2 == 0) {
            dims->push_back((int64_t)iv2);
          } else if (wt2 == 2) {
            Slice pk = v2;
            uint64_t x;
            while (pk.len && read_varint(pk, &x)) dims->push_back((int64_t)x);
          }
        }
      });
    }
  });
}

}  // namespace

extern "C" {

// Index a TFRecord file already mapped/loaded into `buf`: write each
// record's (offset, length) pair. Returns the record count (<= max_records)
// or -1 on framing errors.
int64_t tfrecord_index(const uint8_t* buf, int64_t len, int64_t* offsets,
                       int64_t* lengths, int64_t max_records) {
  int64_t pos = 0, n = 0;
  while (pos + 12 <= len && n < max_records) {
    uint64_t rec_len;
    std::memcpy(&rec_len, buf + pos, 8);
    int64_t data_off = pos + 12;
    if (data_off + (int64_t)rec_len + 4 > len) return -1;
    offsets[n] = data_off;
    lengths[n] = (int64_t)rec_len;
    n++;
    pos = data_off + (int64_t)rec_len + 4;
  }
  return n;
}

// Decode one Frame record.
//   pose16, extrinsic16: output doubles (row-major 4x4)
//   beams: output doubles (beam_count entries; if 0, beam_minmax used)
//   r1/r2: float buffers of capacity `ri_capacity` floats; dims written to
//          r1_dims/r2_dims (up to 3 each, -1 padded)
//   boxes: per vehicle label: 9 doubles (cx cy cz  l w h  heading  type  id_hash)
// Returns 0 on success, negative error codes otherwise.
int32_t waymo_decode_frame(const uint8_t* buf, int64_t len,
                           double* pose16, double* extrinsic16,
                           double* beams, int64_t beams_capacity,
                           int64_t* beam_count, double* beam_minmax,
                           float* r1, float* r2, int64_t ri_capacity,
                           int64_t* r1_dims, int64_t* r2_dims,
                           double* boxes, int64_t boxes_capacity,
                           int64_t* box_count,
                           char* box_ids, int64_t box_ids_capacity) {
  Slice frame{buf, (size_t)len};
  *beam_count = 0;
  *box_count = 0;
  for (int i = 0; i < 3; i++) r1_dims[i] = r2_dims[i] = -1;
  int64_t ids_used = 0;
  bool ok = for_fields(frame, [&](uint32_t f, uint32_t wt, Slice v,
                                  uint64_t iv) {
    if (f == F_FRAME_POSE && wt == 2) {
      std::vector<double> t;
      for_fields(v, [&](uint32_t f2, uint32_t wt2, Slice v2, uint64_t) {
        if (f2 == F_TRANSFORM) collect_doubles(v2, wt2, &t);
      });
      for (size_t i = 0; i < 16 && i < t.size(); i++) pose16[i] = t[i];
    } else if (f == F_FRAME_CONTEXT && wt == 2) {
      for_fields(v, [&](uint32_t f2, uint32_t wt2, Slice v2, uint64_t) {
        if (f2 != F_CONTEXT_LASER_CALIBRATIONS || wt2 != 2) return;
        // check name == TOP before committing
        uint64_t name = 0;
        std::vector<double> bs, ext;
        double bmin = 0, bmax = 0;
        for_fields(v2, [&](uint32_t f3, uint32_t wt3, Slice v3,
                           uint64_t iv3) {
          if (f3 == F_CALIB_NAME) name = iv3;
          else if (f3 == F_CALIB_BEAMS) collect_doubles(v3, wt3, &bs);
          else if (f3 == F_CALIB_BEAM_MIN) bmin = as_double(v3);
          else if (f3 == F_CALIB_BEAM_MAX) bmax = as_double(v3);
          else if (f3 == F_CALIB_EXTRINSIC && wt3 == 2) {
            for_fields(v3, [&](uint32_t f4, uint32_t wt4, Slice v4,
                               uint64_t) {
              if (f4 == F_TRANSFORM) collect_doubles(v4, wt4, &ext);
            });
          }
        });
        if (name != TOP_LIDAR) return;
        for (size_t i = 0; i < 16 && i < ext.size(); i++)
          extrinsic16[i] = ext[i];
        int64_t nb = (int64_t)bs.size();
        if (nb > beams_capacity) nb = beams_capacity;
        for (int64_t i = 0; i < nb; i++) beams[i] = bs[i];
        *beam_count = nb;
        beam_minmax[0] = bmin;
        beam_minmax[1] = bmax;
      });
    } else if (f == F_FRAME_LASERS && wt == 2) {
      uint64_t name = 0;
      Slice ret1{nullptr, 0}, ret2{nullptr, 0};
      for_fields(v, [&](uint32_t f2, uint32_t wt2, Slice v2, uint64_t iv2) {
        if (f2 == F_LASER_NAME) name = iv2;
        else if (f2 == F_LASER_RET1 && wt2 == 2) ret1 = v2;
        else if (f2 == F_LASER_RET2 && wt2 == 2) ret2 = v2;
      });
      if (name != TOP_LIDAR) return;
      auto fill = [&](Slice ri, float* out, int64_t* dims) {
        Slice comp{nullptr, 0};
        for_fields(ri, [&](uint32_t f2, uint32_t wt2, Slice v2, uint64_t) {
          if (f2 == F_RI_COMPRESSED && wt2 == 2) comp = v2;
        });
        if (!comp.p) return;
        std::vector<float> data;
        std::vector<int64_t> dd;
        if (!decode_matrix(comp, &data, &dd)) return;
        for (size_t i = 0; i < 3 && i < dd.size(); i++) dims[i] = dd[i];
        int64_t n = (int64_t)data.size();
        if (n > ri_capacity) n = ri_capacity;
        std::memcpy(out, data.data(), n * 4);
      };
      fill(ret1, r1, r1_dims);
      fill(ret2, r2, r2_dims);
    } else if (f == F_FRAME_LASER_LABELS && wt == 2) {
      double box[7] = {0, 0, 0, 0, 0, 0, 0};
      uint64_t type = 0;
      Slice id{nullptr, 0};
      for_fields(v, [&](uint32_t f2, uint32_t wt2, Slice v2, uint64_t iv2) {
        if (f2 == F_LABEL_TYPE) type = iv2;
        else if (f2 == F_LABEL_ID && wt2 == 2) id = v2;
        else if (f2 == F_LABEL_BOX && wt2 == 2) {
          for_fields(v2, [&](uint32_t f3, uint32_t wt3, Slice v3, uint64_t) {
            if (f3 >= 1 && f3 <= 7 && wt3 == 1) box[f3 - 1] = as_double(v3);
          });
        }
      });
      if (*box_count < boxes_capacity) {
        double* b = boxes + *box_count * 8;
        // layout: cx cy cz  width length height  heading  type
        for (int i = 0; i < 7; i++) b[i] = box[i];
        b[7] = (double)type;
        // id string, '\n' separated
        int64_t need = (int64_t)id.len + 1;
        if (ids_used + need <= box_ids_capacity) {
          std::memcpy(box_ids + ids_used, id.p, id.len);
          ids_used += id.len;
          box_ids[ids_used++] = '\n';
        }
        (*box_count)++;
      }
    }
  });
  if (ids_used < box_ids_capacity) box_ids[ids_used] = '\0';
  return ok ? 0 : -1;
}

}  // extern "C"
