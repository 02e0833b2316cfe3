// Native mission control plane: object tracker + goal queue.
//
// C++ implementations of the reference's hot 5 Hz online nodes
// (3_multi_object_goal_selector.cpp, 3_multi_send_goal_node.cpp) with the
// exact semantics of the Python layer in otslam_tpu_torch/mission/ — the two
// are interchangeable behind the same API (parity-tested). C ABI for ctypes.
// The port's own copy of the JAX package's mission runtime, built by
// otslam_tpu_torch/adapters/native_mission.py under build/.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <set>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Tracker (ObjectClusterMarker equivalent)
// ---------------------------------------------------------------------------

struct TrackerParams {
    double cluster_distance_threshold;
    double wall_thickness_threshold;
    double stability_time;
    double lock_margin;
    double smoothing_factor;
    double unseen_prune_time;
    int32_t min_cluster_points;
};

struct Cluster {
    double cx, cy, width, height, lock_radius;
    double first_seen, last_seen;
};

struct Tracker {
    TrackerParams p;
    std::vector<Cluster> candidates;
    std::vector<Cluster> stable;
    bool tracking_enabled = true;
};

static double lock_radius(const TrackerParams& p, double w, double h) {
    return std::hypot(w, h) / 2.0 + p.lock_margin;
}

Tracker* tracker_create(const TrackerParams* p) {
    auto* t = new Tracker();
    t->p = *p;
    return t;
}

void tracker_destroy(Tracker* t) { delete t; }

void tracker_set_mode(Tracker* t, int enabled) {
    t->tracking_enabled = enabled != 0;
}

int tracker_enabled(const Tracker* t) { return t->tracking_enabled ? 1 : 0; }

// points: (n, 2) doubles in the map frame, in publication order
void tracker_update(Tracker* t, const double* points, int64_t n, double now) {
    if (!t->tracking_enabled) return;
    const TrackerParams& p = t->p;

    // gap clustering over consecutive points (same order-dependence as the
    // reference's vector walk)
    std::vector<Cluster> obs;
    if (n > 0) {
        int64_t start = 0;
        auto flush = [&](int64_t lo, int64_t hi) {  // [lo, hi)
            int64_t cnt = hi - lo;
            if (cnt < p.min_cluster_points) return;
            double mnx = 1e30, mny = 1e30, mxx = -1e30, mxy = -1e30;
            for (int64_t i = lo; i < hi; ++i) {
                mnx = std::min(mnx, points[2 * i]);
                mxx = std::max(mxx, points[2 * i]);
                mny = std::min(mny, points[2 * i + 1]);
                mxy = std::max(mxy, points[2 * i + 1]);
            }
            double w = mxx - mnx, h = mxy - mny;
            if (std::min(w, h) < p.wall_thickness_threshold) return;
            Cluster c;
            c.cx = (mnx + mxx) / 2.0;
            c.cy = (mny + mxy) / 2.0;
            c.width = w;
            c.height = h;
            c.lock_radius = lock_radius(p, w, h);
            c.first_seen = c.last_seen = now;
            obs.push_back(c);
        };
        for (int64_t i = 1; i < n; ++i) {
            double dx = points[2 * i] - points[2 * (i - 1)];
            double dy = points[2 * i + 1] - points[2 * (i - 1) + 1];
            if (std::hypot(dx, dy) > p.cluster_distance_threshold) {
                flush(start, i);
                start = i;
            }
        }
        flush(start, n);
    }

    // association: stable absorbs, candidates EMA-update, else new candidate
    for (const auto& raw : obs) {
        bool matched = false;
        for (auto& s : t->stable) {
            if (std::hypot(raw.cx - s.cx, raw.cy - s.cy) < s.lock_radius) {
                s.last_seen = now;
                matched = true;
                break;
            }
        }
        if (matched) continue;
        for (auto& c : t->candidates) {
            if (std::hypot(raw.cx - c.cx, raw.cy - c.cy) < c.lock_radius) {
                double a = p.smoothing_factor;
                c.last_seen = now;
                c.cx = c.cx * (1 - a) + raw.cx * a;
                c.cy = c.cy * (1 - a) + raw.cy * a;
                c.width = c.width * (1 - a) + raw.width * a;
                c.height = c.height * (1 - a) + raw.height * a;
                c.lock_radius = lock_radius(p, c.width, c.height);
                matched = true;
                break;
            }
        }
        if (!matched) t->candidates.push_back(raw);
    }

    // promotion / pruning
    std::vector<Cluster> remaining;
    for (auto& c : t->candidates) {
        if (now - c.first_seen > p.stability_time) {
            t->stable.push_back(c);
        } else if (now - c.last_seen > p.unseen_prune_time) {
            // dropped
        } else {
            remaining.push_back(c);
        }
    }
    t->candidates = remaining;
}

int64_t tracker_num_stable(const Tracker* t) {
    return (int64_t)t->stable.size();
}

int64_t tracker_num_candidates(const Tracker* t) {
    return (int64_t)t->candidates.size();
}

// out: (n, 5) doubles [cx, cy, width, height, lock_radius]
void tracker_get_stable(const Tracker* t, double* out) {
    for (size_t i = 0; i < t->stable.size(); ++i) {
        const auto& c = t->stable[i];
        out[5 * i] = c.cx;
        out[5 * i + 1] = c.cy;
        out[5 * i + 2] = c.width;
        out[5 * i + 3] = c.height;
        out[5 * i + 4] = c.lock_radius;
    }
}

// ---------------------------------------------------------------------------
// Goal queue (GoalSender equivalent)
// ---------------------------------------------------------------------------

struct Target {
    int32_t unique_id;
    int32_t object_id;
    int32_t is_removed;
    double x, y, yaw;
};

struct Sender {
    double reach_threshold;
    std::vector<Target> added, removed;
    std::set<int32_t> visited, visited_removed;
    double rx = 0, ry = 0;
    int32_t active_id = -1;
    int32_t focus = -1;
    Target active{};
};

Sender* sender_create(double reach_threshold) {
    auto* s = new Sender();
    s->reach_threshold = reach_threshold;
    return s;
}

void sender_destroy(Sender* s) { delete s; }

void sender_on_odom(Sender* s, double x, double y) {
    s->rx = x;
    s->ry = y;
}

// targets: (n, 6) doubles [unique_id, object_id, x, y, yaw, is_removed]
static void fill_targets(std::vector<Target>& list,
                         const std::set<int32_t>& visited,
                         const double* data, int64_t n, int removed) {
    list.clear();
    for (int64_t i = 0; i < n; ++i) {
        Target t;
        t.unique_id = (int32_t)data[6 * i];
        t.object_id = (int32_t)data[6 * i + 1];
        t.x = data[6 * i + 2];
        t.y = data[6 * i + 3];
        t.yaw = data[6 * i + 4];
        t.is_removed = removed;
        if (!visited.count(t.unique_id)) list.push_back(t);
    }
}

void sender_on_added(Sender* s, const double* data, int64_t n) {
    fill_targets(s->added, s->visited, data, n, 0);
}

void sender_on_removed(Sender* s, const double* data, int64_t n) {
    fill_targets(s->removed, s->visited_removed, data, n, 1);
}

static double dist_to(const Sender* s, const Target& t) {
    return std::hypot(s->rx - t.x, s->ry - t.y);
}

// returns 1 and fills out when a goal should be (re)published, else 0
int sender_control_step(Sender* s, Target* out) {
    // 1. reach check
    if (s->active_id != -1 && dist_to(s, s->active) < s->reach_threshold) {
        if (s->active.is_removed)
            s->visited_removed.insert(s->active_id);
        else
            s->visited.insert(s->active_id);
        s->active_id = -1;
    }

    // 2. select next when idle: sticky (same object, added type), then greedy
    if (s->active_id == -1) {
        const Target* best = nullptr;
        double best_d = 1e30;
        if (s->focus != -1) {
            for (const auto& t : s->added) {
                if (t.object_id != s->focus || s->visited.count(t.unique_id))
                    continue;
                double d = dist_to(s, t);
                if (d < best_d) {
                    best_d = d;
                    best = &t;
                }
            }
        }
        if (!best) {
            best_d = 1e30;
            auto consider = [&](const std::vector<Target>& list,
                                const std::set<int32_t>& vis) {
                for (const auto& t : list) {
                    if (vis.count(t.unique_id)) continue;
                    double d = dist_to(s, t);
                    if (d < best_d) {
                        best_d = d;
                        best = &t;
                    }
                }
            };
            consider(s->added, s->visited);
            consider(s->removed, s->visited_removed);
        }
        if (best) {
            s->active = *best;
            s->active_id = best->unique_id;
            s->focus = best->object_id;
            *out = s->active;
            return 1;
        }
        return 0;
    }

    // 3. republish while distant
    if (dist_to(s, s->active) > s->reach_threshold) {
        *out = s->active;
        return 1;
    }
    return 0;
}

int64_t sender_pending(const Sender* s) {
    int64_t n = 0;
    for (const auto& t : s->added)
        if (!s->visited.count(t.unique_id)) n++;
    for (const auto& t : s->removed)
        if (!s->visited_removed.count(t.unique_id)) n++;
    return n;
}

}  // extern "C"
