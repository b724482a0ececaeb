// Copied from fdc_tpu/runtime/native/emission.cc (verbatim below this line).
// Native emission engine: burst assembly + event production in C++.
//
// Replays the per-block emission logic of the reference blocks
// (PowerActivationChannel_impl.cc:137-258, SegmentDetection_impl.cc:346-549)
// over the device step's flag/extraction outputs. The Python emitters in
// fdc_tpu/runtime/emission.py are the reference implementation; this engine
// is their drop-in fast path — the per-(block x channel) loop is the host
// bottleneck at pod scale (512+ dynamic channels x hundreds of blocks per
// step is tens of thousands of Python iterations per batch).
//
// C ABI for ctypes. One engine instance owns the host state of one
// SegmentDetector's slots or one PowerActivationBank's channels: burst
// buffers, counters, message ids. Events are drained through a poll call;
// event sample data pointers stay valid until the next drain or step call.

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <deque>
#include <string>
#include <vector>

namespace {

using cfloat = std::complex<float>;

struct EventOut {
    std::string id;
    int finalized;       // bool
    long long part;      // -1 => "no part field" (seg fin without partials)
    double rel_cfreq;
    double rel_bw;
    long long blockstart;
    long long blockend;
    long long vectorstart;  // -1 => absent (powact events)
    long long vectorend;
    std::vector<cfloat> data;
};

struct SlotState {
    std::deque<std::vector<cfloat>> blocks;  // per-block samples
    long long count = 0;   // blocks accumulated since activation
    long long part = 0;    // partial-emission counter
    std::string msg_id;
    long long es = 0, ee = 0, w = 0;
    bool live = false;
};

struct Engine {
    // config
    int mode;            // 0 = segment detection, 1 = power activation,
                         // 2 = segment detection with vcm conventions
                         //     (blockcount base 1, inline partial emission;
                         //      reference: activity_detection_channelizer_vcm)
    int n_units;         // slots or channels
    int relinvovl;
    long long blocksize;
    long long maxblocks;
    std::vector<cfloat> rot;  // e^{2pi i p / R}

    // per-unit static geometry (powact mode)
    std::vector<long long> pa_out_len;   // samples kept per block
    std::vector<double> pa_rel_cfreq, pa_rel_bw;
    std::vector<long long> pa_finished;  // finished-burst counter (ID suffix)

    std::vector<SlotState> units;
    std::deque<EventOut> events;
    EventOut current;  // last polled event (owns data until next poll)
    long long lost_rows = 0;  // blocks beyond the extraction budget (zeroed)
    // msgoutput/fileoutput both off: skip event sample assembly entirely
    // (the reference gates PDU construction on d_msgoutput,
    // lib/SegmentDetection_impl.cc:446-460); state updates are unaffected.
    bool want_data = true;
};

void emit_seg(Engine* e, int s, bool fin, long long blockcount,
              size_t ntx) {
    SlotState& st = e->units[s];
    EventOut ev;
    ev.id = st.msg_id;
    ev.finalized = fin ? 1 : 0;
    // fin events carry `part` only if partial emissions happened
    // (reference: lib/SegmentDetection_impl.cc:450-451,506)
    ev.part = (!fin || st.part > 0) ? st.part : -1;
    ev.rel_bw = double(st.w) / double(e->blocksize);
    ev.rel_cfreq = double(st.es + st.ee) / 2.0 / double(e->blocksize);
    ev.blockstart = blockcount - st.count;
    ev.blockend = blockcount;
    ev.vectorstart = st.es;
    ev.vectorend = st.ee;
    if (e->want_data) {
        size_t total = 0;
        for (size_t i = 0; i < ntx; ++i) total += st.blocks[i].size();
        ev.data.reserve(total);
        for (size_t i = 0; i < ntx; ++i) {
            ev.data.insert(ev.data.end(), st.blocks[i].begin(),
                           st.blocks[i].end());
        }
    }
    st.blocks.erase(st.blocks.begin(), st.blocks.begin() + ntx);
    if (!fin) st.part += 1;
    e->events.push_back(std::move(ev));
}

void emit_pa(Engine* e, int c, bool fin, long long blockcount) {
    SlotState& st = e->units[c];
    EventOut ev;
    // dict ID carries a .fin/.part suffix
    // (reference: lib/PowerActivationChannel_impl.cc:224)
    ev.id = st.msg_id + (fin ? ".fin" : ".part");
    ev.finalized = fin ? 1 : 0;
    ev.part = st.part;
    ev.rel_cfreq = e->pa_rel_cfreq[c];
    ev.rel_bw = e->pa_rel_bw[c];
    ev.blockstart = blockcount - st.count;
    ev.blockend = blockcount;
    ev.vectorstart = -1;
    ev.vectorend = -1;
    if (e->want_data) {
        size_t total = 0;
        for (auto& b : st.blocks) total += b.size();
        ev.data.reserve(total);
        for (auto& b : st.blocks)
            ev.data.insert(ev.data.end(), b.begin(), b.end());
    }
    st.blocks.clear();
    st.part += 1;
    e->events.push_back(std::move(ev));
}

}  // namespace

extern "C" {

Engine* fdc_emit_create(int mode, int n_units, int relinvovl,
                        long long blocksize, long long maxblocks) {
    Engine* e = new Engine();
    e->mode = mode;
    e->n_units = n_units;
    e->relinvovl = relinvovl;
    e->blocksize = blocksize;
    e->maxblocks = maxblocks;
    e->rot.resize(relinvovl);
    for (int p = 0; p < relinvovl; ++p) {
        double a = 2.0 * M_PI * p / relinvovl;
        e->rot[p] = cfloat(float(std::cos(a)), float(std::sin(a)));
    }
    e->units.resize(n_units);
    e->pa_out_len.assign(n_units, 0);
    e->pa_rel_cfreq.assign(n_units, 0.0);
    e->pa_rel_bw.assign(n_units, 0.0);
    e->pa_finished.assign(n_units, 0);
    return e;
}

void fdc_emit_destroy(Engine* e) { delete e; }

// Configure one power-activation channel's static geometry.
void fdc_emit_pa_set_channel(Engine* e, int c, long long out_len,
                             double rel_cfreq, double rel_bw) {
    e->pa_out_len[c] = out_len;
    e->pa_rel_cfreq[c] = rel_cfreq;
    e->pa_rel_bw[c] = rel_bw;
}

long long fdc_emit_pa_finished(Engine* e, int c) {
    return e->pa_finished[c];
}

// 0 disables event sample assembly (msgoutput and fileoutput both off).
void fdc_emit_set_want_data(Engine* e, int want) {
    e->want_data = want != 0;
}

long long fdc_emit_lost_rows(Engine* e) { return e->lost_rows; }

// Discard one unit's buffered burst WITHOUT emission (split-segment cut
// reconciliation: the slot was killed as a cross-part duplicate — its
// twin in the adjacent part's engine holds the data). Mirrors the Python
// emitter's killed-slot reset: live/data/count/part/msg_id cleared,
// es/ee/w left in place (overwritten at the next activation).
void fdc_emit_kill_unit(Engine* e, int u) {
    if (!e || u < 0 || u >= e->n_units) return;
    SlotState& st = e->units[u];
    st.blocks.clear();
    st.count = 0;
    st.part = 0;
    st.msg_id.clear();
    st.live = false;
}

// --------------------------------------------------------------------------
// Segment-detection step.
// Flags are [S, B] row-major uint8/int32; extract is [E, B+1, l_cap]
// complex64 (interleaved float) holding the COMPACTED rows named by
// slot_ids[E] (device-side output compaction; a slot with no row this step
// contributes zeros and bumps lost_rows). ids is S concatenated
// NUL-terminated strings (msg id for every slot as-if activated this step;
// only consumed for slots that DO activate).
// --------------------------------------------------------------------------
int fdc_emit_seg_step(
    Engine* e, int n_blocks, int l_cap,
    int n_ext, const int32_t* slot_ids,
    const uint8_t* activated, const uint8_t* processed,
    const uint8_t* emit_flags, const int32_t* phase_used,
    const float* extract,
    int l_cap2, int n_ext2, const int32_t* slot_ids2,
    const float* extract2,
    const int32_t* ext_start, const int32_t* wlog2,
    const int32_t* order,
    const char* ids,
    long long t0) {
    const int s_total = e->n_units;
    const int r = e->relinvovl;
    const long long mb = e->maxblocks;

    // unpack per-slot id strings
    std::vector<const char*> idp(s_total);
    {
        const char* p = ids;
        for (int s = 0; s < s_total; ++s) {
            idp[s] = p;
            p += std::strlen(p) + 1;
        }
    }

    // The reference iterates channels in ACTIVATION order (append-ordered
    // deque, lib/SegmentDetection_impl.cc:346-365); after slot recycling a
    // newer channel can sit at a lower slot index, so all per-block loops
    // walk slots ranked by their occupant's activation sequence number
    // (slots are never recycled within a step).
    std::vector<int> rank(s_total);
    for (int i = 0; i < s_total; ++i) rank[i] = i;
    std::stable_sort(rank.begin(), rank.end(),
                     [&](int a, int b) { return order[a] < order[b]; });

    auto flag = [n_blocks](const uint8_t* a, int s, int b) {
        return a[(size_t)s * n_blocks + b] != 0;
    };
    // compacted extraction rows: slot -> row index (or -1 = lost). Plan
    // entries >= s_total are unused-row sentinels. A slot's row lives in
    // the wide bucket or, when configured (extract_width_split), the
    // narrow bucket.
    std::vector<int> row_of(s_total, -1), row_of2(s_total, -1);
    for (int i = 0; i < n_ext; ++i) {
        int s = slot_ids[i];
        if (s >= 0 && s < s_total) row_of[s] = i;
    }
    for (int i = 0; i < n_ext2; ++i) {
        int s = slot_ids2[i];
        if (s >= 0 && s < s_total) row_of2[s] = i;
    }
    // decode one block from an interpolated extraction row: sample at
    // stride q = cap/w and apply the fftshift sign compensation (-1)^m
    // (see fdc_tpu/ops/fft.py interp_subband_ifft;
    // reference behavior: lib/SegmentDetection_impl.cc:431-435);
    // no row in either bucket => beyond the budget: zeros + count
    auto take_row = [&](int s, int b_row, long long w, cfloat ph) {
        long long ovl = w / r;
        long long outlen = w - ovl;
        std::vector<cfloat> v(outlen);
        const float* base = extract;
        long long cap = l_cap;
        int rr = row_of[s];
        if (rr < 0 && n_ext2 > 0) {
            rr = row_of2[s];
            base = extract2;
            cap = l_cap2;
        }
        if (rr < 0) {
            e->lost_rows += 1;
            return v;  // zeros
        }
        long long q = cap / w;
        const cfloat* p = reinterpret_cast<const cfloat*>(
            base + 2 * ((size_t)rr * (n_blocks + 1) + b_row) * cap);
        for (long long i = 0; i < outlen; ++i) {
            float sign = ((ovl + i) & 1) ? -1.0f : 1.0f;
            v[i] = p[(ovl + i) * q] * (ph * sign);
        }
        return v;
    };

    auto do_activate = [&](int s, int b) {
        SlotState& st = e->units[s];
        long long w = 1LL << wlog2[s];
        st.live = true;
        st.blocks.clear();
        st.count = 0;
        st.part = 0;
        st.es = ext_start[s];
        st.ee = st.es + w;
        st.w = w;
        st.msg_id = idp[s];
        // hist block (phase 0) then current block
        cfloat ph = e->rot[phase_used[(size_t)s * n_blocks + b] % r];
        st.blocks.push_back(take_row(s, b, w, cfloat(1.0f, 0.0f)));
        st.blocks.push_back(take_row(s, b + 1, w, ph));
        st.count += 2;
    };
    auto do_process = [&](int s, int b) {
        SlotState& st = e->units[s];
        cfloat ph = e->rot[phase_used[(size_t)s * n_blocks + b] % r];
        st.blocks.push_back(take_row(s, b + 1, st.w, ph));
        st.count += 1;
    };

    const bool vcm = (e->mode == 2);
    for (int b = 0; b < n_blocks; ++b) {
        if (vcm) {
            // vcm conventions: blockcount starts at 1; one unified walk in
            // activation order with the maxblocks partial emission INLINE
            // per channel (reference:
            // lib/activity_detection_channelizer_vcm_impl.cc:188,305-321)
            long long blockcount = t0 + b + 1;
            for (int s : rank) {
                bool act = flag(activated, s, b);
                bool em = flag(emit_flags, s, b);
                bool proc = flag(processed, s, b);
                if (!act && !em && !proc) continue;
                if (act) {
                    do_activate(s, b);
                } else if (em) {
                    emit_seg(e, s, true, blockcount,
                             e->units[s].blocks.size());
                    e->units[s].live = false;
                } else if (proc) {
                    do_process(s, b);
                }
                SlotState& st = e->units[s];
                if (mb >= 0 && st.live &&
                    (long long)st.blocks.size() >= mb) {
                    size_t ntx =
                        (mb == 0) ? st.blocks.size() : (size_t)mb;
                    if (ntx > 0)
                        emit_seg(e, s, false, blockcount, ntx);
                }
            }
            continue;
        }

        long long blockcount = t0 + b;  // SegmentDetection convention
        for (int s : rank) {
            if (!flag(activated, s, b)) continue;
            do_activate(s, b);
        }
        for (int s : rank) {
            if (!flag(processed, s, b) || flag(activated, s, b)) continue;
            do_process(s, b);
        }
        for (int s : rank) {
            if (!flag(emit_flags, s, b)) continue;
            emit_seg(e, s, true, blockcount, e->units[s].blocks.size());
            e->units[s].live = false;
        }
        // maxblocks partial emission after all per-block work
        // (reference: lib/SegmentDetection_impl.cc:359-362)
        if (mb >= 0) {
            for (int s : rank) {
                SlotState& st = e->units[s];
                if (!st.live) continue;
                if ((long long)st.blocks.size() >= mb) {
                    size_t ntx =
                        (mb == 0) ? st.blocks.size() : (size_t)mb;
                    if (ntx > 0)
                        emit_seg(e, s, false, blockcount, ntx);
                }
            }
        }
    }
    return (int)e->events.size();
}

// --------------------------------------------------------------------------
// Power-activation step. Flags [C, B]; extract [C, B+1, out_cap] complex64
// where each channel's valid samples per row are pa_out_len[c] (rows are the
// overlap-trimmed extraction). id_prefix: "<timestamp>.PowActChan"; the
// engine appends ".<channel>.<finished_count>" at each rise (a channel can
// burst more than once within a step, so IDs must be built here,
// reference: lib/PowerActivationChannel_impl.cc:308-312).
// --------------------------------------------------------------------------
int fdc_emit_pa_step(
    Engine* e, int n_blocks, int out_cap,
    const uint8_t* rise, const uint8_t* fall, const uint8_t* processed,
    const int32_t* phase_used,
    const float* extract,
    const char* id_prefix,
    long long t0) {
    const int c_total = e->n_units;
    const int r = e->relinvovl;
    const long long mb = e->maxblocks;

    auto flag = [n_blocks](const uint8_t* a, int c, int b) {
        return a[(size_t)c * n_blocks + b] != 0;
    };
    auto row = [&](int c, int b_row) {
        return reinterpret_cast<const cfloat*>(
            extract + 2 * ((size_t)c * (n_blocks + 1) + b_row) * out_cap);
    };

    for (int b = 0; b < n_blocks; ++b) {
        long long blockcount = t0 + b + 1;  // PowerActivation convention
        for (int c = 0; c < c_total; ++c) {
            bool rises = flag(rise, c, b);
            bool proc = flag(processed, c, b);
            if (!rises && !proc) continue;
            SlotState& st = e->units[c];
            long long outlen = e->pa_out_len[c];
            if (rises) {
                // activate: reset burst, process hist + current block
                // (reference: lib/PowerActivationChannel_impl.cc:198-210)
                st.part = 0;
                st.count = 0;
                st.blocks.clear();
                st.msg_id = std::string(id_prefix) + "." +
                            std::to_string(c) + "." +
                            std::to_string(e->pa_finished[c]);
                const cfloat* h = row(c, b);
                st.blocks.emplace_back(h, h + outlen);
                cfloat ph =
                    e->rot[phase_used[(size_t)c * n_blocks + b] % r];
                const cfloat* cur = row(c, b + 1);
                std::vector<cfloat> cv(outlen);
                for (long long i = 0; i < outlen; ++i)
                    cv[i] = cur[i] * ph;
                st.blocks.push_back(std::move(cv));
                st.count += 2;
            } else if (proc) {
                cfloat ph =
                    e->rot[phase_used[(size_t)c * n_blocks + b] % r];
                const cfloat* cur = row(c, b + 1);
                std::vector<cfloat> cv(outlen);
                for (long long i = 0; i < outlen; ++i)
                    cv[i] = cur[i] * ph;
                st.blocks.push_back(std::move(cv));
                st.count += 1;
            }
            if (flag(fall, c, b)) {
                emit_pa(e, c, true, blockcount);
                e->pa_finished[c] += 1;
            } else if (proc && !rises &&
                       (mb == 0 || (mb > 0 && st.count % mb == 0))) {
                // partial emission while active
                // (reference: lib/PowerActivationChannel_impl.cc:159-166)
                emit_pa(e, c, false, blockcount);
            }
        }
    }
    return (int)e->events.size();
}

// --------------------------------------------------------------------------
// Event drain. Call next() until it returns 0. Metadata written through
// pointers; the sample-data pointer stays valid until the next call.
// --------------------------------------------------------------------------
int fdc_emit_next_event(
    Engine* e,
    const char** id, int* finalized, long long* part,
    double* rel_cfreq, double* rel_bw,
    long long* blockstart, long long* blockend,
    long long* vectorstart, long long* vectorend,
    const float** data, long long* n_samples) {
    if (e->events.empty()) return 0;
    e->current = std::move(e->events.front());
    e->events.pop_front();
    *id = e->current.id.c_str();
    *finalized = e->current.finalized;
    *part = e->current.part;
    *rel_cfreq = e->current.rel_cfreq;
    *rel_bw = e->current.rel_bw;
    *blockstart = e->current.blockstart;
    *blockend = e->current.blockend;
    *vectorstart = e->current.vectorstart;
    *vectorend = e->current.vectorend;
    *data = reinterpret_cast<const float*>(e->current.data.data());
    *n_samples = (long long)e->current.data.size();
    return 1;
}

// Serialize burst state for checkpointing: returns required byte size when
// buf == nullptr, else writes and returns bytes written.
// Layout per unit: count, part, es, ee, w, live, n_blocks_buffered,
// fin, id_len, id bytes, then per buffered block: len + samples.
// (fin = the powact finished flag, written between n_blocks and id_len —
// keep in sync with the Python _UNIT_HDR parser.)
long long fdc_emit_save_state(Engine* e, uint8_t* buf) {
    long long off = 0;
    auto put = [&](const void* p, size_t nbytes) {
        if (buf) std::memcpy(buf + off, p, nbytes);
        off += (long long)nbytes;
    };
    for (int u = 0; u < e->n_units; ++u) {
        SlotState& st = e->units[u];
        long long live = st.live ? 1 : 0;
        long long nb = (long long)st.blocks.size();
        long long idl = (long long)st.msg_id.size();
        long long fin = e->pa_finished[u];
        put(&st.count, 8); put(&st.part, 8); put(&st.es, 8);
        put(&st.ee, 8); put(&st.w, 8); put(&live, 8); put(&nb, 8);
        put(&fin, 8); put(&idl, 8);
        put(st.msg_id.data(), st.msg_id.size());
        for (auto& blk : st.blocks) {
            long long bl = (long long)blk.size();
            put(&bl, 8);
            put(blk.data(), blk.size() * sizeof(cfloat));
        }
    }
    return off;
}

int fdc_emit_load_state(Engine* e, const uint8_t* buf, long long nbytes) {
    long long off = 0;
    auto get = [&](void* p, size_t n) -> bool {
        if (off + (long long)n > nbytes) return false;
        std::memcpy(p, buf + off, n);
        off += (long long)n;
        return true;
    };
    for (int u = 0; u < e->n_units; ++u) {
        SlotState& st = e->units[u];
        long long live = 0, nb = 0, idl = 0, fin = 0;
        if (!get(&st.count, 8) || !get(&st.part, 8) || !get(&st.es, 8) ||
            !get(&st.ee, 8) || !get(&st.w, 8) || !get(&live, 8) ||
            !get(&nb, 8) || !get(&fin, 8) || !get(&idl, 8))
            return 0;
        st.live = live != 0;
        e->pa_finished[u] = fin;
        st.msg_id.resize((size_t)idl);
        if (idl && !get(&st.msg_id[0], (size_t)idl)) return 0;
        st.blocks.clear();
        for (long long i = 0; i < nb; ++i) {
            long long bl = 0;
            if (!get(&bl, 8)) return 0;
            std::vector<cfloat> blk((size_t)bl);
            if (bl && !get(blk.data(), (size_t)bl * sizeof(cfloat)))
                return 0;
            st.blocks.push_back(std::move(blk));
        }
    }
    return off == nbytes ? 1 : 0;
}

}  // extern "C"
