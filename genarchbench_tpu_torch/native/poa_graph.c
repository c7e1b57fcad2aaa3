/* poa_graph.c — native partial-order-alignment graph engine.
 *
 * Same role as spoa's Graph (reference bundle poa/spoa.tar.bz2
 * graph.cpp: add_alignment/fusion :117-271, iterative-DFS topological
 * sort with aligned-node grouping :293-352, heaviest-bundle consensus
 * with branch completion :494-586).  The structure is an original
 * handle-based C design (flat edge pool + per-node index lists) that
 * reproduces the exact visit/tie-break order the DP and consensus
 * depend on; the Python Graph class in kernels/poa.py is its plain
 * version, with identical semantics, which the tests hold it to.
 *
 * The device DP (kernels/poa.py) emits per-window walk arrays; the
 * add_alignment entry point consumes those raw walks (rank-indexed,
 * reverse order) so no per-step Python objects are ever built.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    int32_t begin, end;
    int64_t weight;
} PoaEdge;

typedef struct {
    int32_t *data;
    int32_t len, cap;
} IList;

typedef struct {
    uint8_t *code;           /* per node: raw character               */
    IList *in_e, *out_e;     /* per node: indices into edge pool      */
    IList *aligned;          /* per node: aligned node ids            */
    int32_t n_nodes, cap_nodes;
    PoaEdge *edges;
    int32_t n_edges, cap_edges;
    int32_t *rank;           /* rank_to_node_id                       */
    int32_t n_rank, cap_rank;
    int32_t num_sequences;
} PoaGraph;

static void il_push(IList *l, int32_t v) {
    if (l->len == l->cap) {
        l->cap = l->cap ? l->cap * 2 : 4;
        l->data = (int32_t *)realloc(l->data, (size_t)l->cap * 4);
    }
    l->data[l->len++] = v;
}

void *poa_new(void) {
    return calloc(1, sizeof(PoaGraph));
}

void poa_free(void *h) {
    PoaGraph *g = (PoaGraph *)h;
    if (!g) return;
    for (int32_t i = 0; i < g->n_nodes; i++) {
        free(g->in_e[i].data);
        free(g->out_e[i].data);
        free(g->aligned[i].data);
    }
    free(g->code); free(g->in_e); free(g->out_e); free(g->aligned);
    free(g->edges); free(g->rank); free(g);
}

static int32_t add_node(PoaGraph *g, uint8_t code) {
    if (g->n_nodes == g->cap_nodes) {
        int32_t nc = g->cap_nodes ? g->cap_nodes * 2 : 64;
        g->code = (uint8_t *)realloc(g->code, (size_t)nc);
        g->in_e = (IList *)realloc(g->in_e, (size_t)nc * sizeof(IList));
        g->out_e = (IList *)realloc(g->out_e, (size_t)nc * sizeof(IList));
        g->aligned = (IList *)realloc(g->aligned,
                                      (size_t)nc * sizeof(IList));
        g->cap_nodes = nc;
    }
    int32_t id = g->n_nodes++;
    g->code[id] = code;
    memset(&g->in_e[id], 0, sizeof(IList));
    memset(&g->out_e[id], 0, sizeof(IList));
    memset(&g->aligned[id], 0, sizeof(IList));
    return id;
}

static void add_edge(PoaGraph *g, int32_t begin, int32_t end,
                     int64_t weight) {
    IList *oe = &g->out_e[begin];
    for (int32_t i = 0; i < oe->len; i++) {
        PoaEdge *e = &g->edges[oe->data[i]];
        if (e->end == end) { e->weight += weight; return; }
    }
    if (g->n_edges == g->cap_edges) {
        g->cap_edges = g->cap_edges ? g->cap_edges * 2 : 64;
        g->edges = (PoaEdge *)realloc(
            g->edges, (size_t)g->cap_edges * sizeof(PoaEdge));
    }
    int32_t ei = g->n_edges++;
    g->edges[ei].begin = begin;
    g->edges[ei].end = end;
    g->edges[ei].weight = weight;
    il_push(&g->out_e[begin], ei);
    il_push(&g->in_e[end], ei);
}

/* graph.cpp:139-154 — chain of fresh nodes for seq[begin..end) */
static int32_t add_sequence(PoaGraph *g, const uint8_t *seq,
                            const int64_t *w, int32_t begin,
                            int32_t end) {
    if (begin == end) return -1;
    int32_t first = add_node(g, seq[begin]);
    for (int32_t i = begin + 1; i < end; i++) {
        int32_t nid = add_node(g, seq[i]);
        add_edge(g, nid - 1, nid, w[i - 1] + w[i]);
    }
    return first;
}

/* graph.cpp:293-352 — the exact DFS visit order defines ranks */
static void topological_sort(PoaGraph *g) {
    int32_t n = g->n_nodes;
    g->n_rank = 0;
    if (g->cap_rank < n) {
        g->cap_rank = n;
        g->rank = (int32_t *)realloc(g->rank, (size_t)n * 4);
    }
    uint8_t *marks = (uint8_t *)calloc((size_t)n, 1);
    uint8_t *check = (uint8_t *)malloc((size_t)n);
    memset(check, 1, (size_t)n);
    int32_t *stack = (int32_t *)malloc((size_t)n * 8 * 4);
    int64_t scap = (int64_t)n * 8, slen;
    for (int32_t i = 0; i < n; i++) {
        if (marks[i]) continue;
        slen = 0;
        stack[slen++] = i;
        while (slen) {
            int32_t nid = stack[slen - 1];
            int valid = 1;
            if (marks[nid] != 2) {
                IList *ie = &g->in_e[nid];
                if (slen + ie->len + g->aligned[nid].len + 2 >= scap) {
                    scap = (slen + ie->len + g->aligned[nid].len + 2) * 2;
                    stack = (int32_t *)realloc(stack, (size_t)scap * 4);
                }
                for (int32_t k = 0; k < ie->len; k++) {
                    int32_t b = g->edges[ie->data[k]].begin;
                    if (marks[b] != 2) { stack[slen++] = b; valid = 0; }
                }
                if (check[nid]) {
                    IList *al = &g->aligned[nid];
                    for (int32_t k = 0; k < al->len; k++) {
                        int32_t a = al->data[k];
                        if (marks[a] != 2) {
                            stack[slen++] = a;
                            check[a] = 0;
                            valid = 0;
                        }
                    }
                }
                if (valid) {
                    marks[nid] = 2;
                    if (check[nid]) {
                        g->rank[g->n_rank++] = nid;
                        IList *al = &g->aligned[nid];
                        for (int32_t k = 0; k < al->len; k++)
                            g->rank[g->n_rank++] = al->data[k];
                    }
                } else {
                    marks[nid] = 1;
                }
            }
            if (valid) slen--;
        }
    }
    free(marks); free(check); free(stack);
}

/* add_alignment from a raw device walk (reverse step order; slot a>0
 * means rank a-1 at the PRE-add graph, a==-1 no node; b>=0 query idx).
 * have_aln==0 replicates the empty-alignment fast path
 * (graph.cpp:121-137).  Returns 0, or -1 on malformed input. */
int poa_add_alignment(void *h, const int16_t *ei, const int16_t *ej,
                      int64_t nstep, const uint8_t *seq, int64_t n,
                      int have_aln) {
    PoaGraph *g = (PoaGraph *)h;
    if (n == 0) return 0;
    int64_t *w = (int64_t *)malloc((size_t)n * 8);
    for (int64_t i = 0; i < n; i++) w[i] = 1;   /* default weights */

    if (!have_aln) {
        add_sequence(g, seq, w, 0, (int32_t)n);
        g->num_sequences++;
        topological_sort(g);
        free(w);
        return 0;
    }
    /* map walk -> (node_id, q) path in forward order */
    int32_t *pn = (int32_t *)malloc((size_t)nstep * 4);
    int32_t *pq = (int32_t *)malloc((size_t)nstep * 4);
    int64_t np = 0;
    for (int64_t s = nstep - 1; s >= 0; s--) {
        int32_t a = ei[s], b = ej[s];
        pn[np] = a > 0 ? g->rank[a - 1] : -1;
        pq[np] = b >= 0 ? b : -1;
        np++;
    }
    int32_t vfirst = -1, vlast = -1;
    for (int64_t i = 0; i < np; i++)
        if (pq[i] != -1) { if (vfirst < 0) vfirst = pq[i]; vlast = pq[i]; }
    if (vfirst < 0) { free(pn); free(pq); free(w); return -1; }

    int32_t tmp = g->n_nodes;
    int32_t begin_id = add_sequence(g, seq, w, 0, vfirst);
    int32_t head = (tmp == g->n_nodes) ? -1 : g->n_nodes - 1;
    int32_t tail = add_sequence(g, seq, w, vlast + 1, (int32_t)n);

    int32_t new_id = -1;
    int64_t prev_w = (head == -1) ? 0 : w[vfirst - 1];
    for (int64_t i = 0; i < np; i++) {
        if (pq[i] == -1) continue;
        uint8_t letter = seq[pq[i]];
        int32_t nid = pn[i];
        if (nid == -1) {
            new_id = add_node(g, letter);
        } else if (g->code[nid] == letter) {
            new_id = nid;
        } else {
            int32_t aligned_to = -1;
            IList *al = &g->aligned[nid];
            for (int32_t k = 0; k < al->len; k++)
                if (g->code[al->data[k]] == letter) {
                    aligned_to = al->data[k];
                    break;
                }
            if (aligned_to == -1) {
                new_id = add_node(g, letter);
                al = &g->aligned[nid];     /* re-read: add_node reallocs */
                for (int32_t k = 0; k < al->len; k++) {
                    il_push(&g->aligned[new_id], al->data[k]);
                    il_push(&g->aligned[al->data[k]], new_id);
                }
                il_push(&g->aligned[new_id], nid);
                il_push(&g->aligned[nid], new_id);
            } else {
                new_id = aligned_to;
            }
        }
        if (begin_id == -1) begin_id = new_id;
        if (head != -1) add_edge(g, head, new_id, prev_w + w[pq[i]]);
        head = new_id;
        prev_w = w[pq[i]];
    }
    if (tail != -1) add_edge(g, head, tail, prev_w + w[vlast + 1]);
    g->num_sequences++;
    topological_sort(g);
    free(pn); free(pq); free(w);
    return 0;
}

int64_t poa_num_ranks(void *h) { return ((PoaGraph *)h)->n_rank; }

void poa_get_ranks(void *h, int32_t *out) {
    PoaGraph *g = (PoaGraph *)h;
    memcpy(out, g->rank, (size_t)g->n_rank * 4);
}

int64_t poa_max_in_edges(void *h) {
    PoaGraph *g = (PoaGraph *)h;
    int32_t mx = 0;
    for (int32_t r = 0; r < g->n_rank; r++) {
        int32_t c = g->in_e[g->rank[r]].len;
        if (c > mx) mx = c;
    }
    return mx;
}

/* Fill DP-prep arrays for kernels/poa.py::align_many: per-rank node
 * character, predecessor rank+1 list (stride P), count, end mask, and
 * the column-0 boundary series O0/F0 (sisd_alignment_engine.cpp
 * :116-160 translated to ranks).  Arrays sized R (O0/F0: R+1). */
void poa_export_dp(void *h, int64_t P, int32_t *codes, int32_t *preds,
                   int32_t *npred, uint8_t *endmask, int64_t *O0,
                   int64_t *F0, int64_t pen_g, int64_t pen_e,
                   int64_t pen_q, int64_t pen_c) {
    PoaGraph *g = (PoaGraph *)h;
    int32_t *id2rank = (int32_t *)malloc((size_t)g->n_nodes * 4);
    for (int32_t r = 0; r < g->n_rank; r++) id2rank[g->rank[r]] = r;
    O0[0] = 0; F0[0] = 0;
    for (int32_t r = 0; r < g->n_rank; r++) {
        int32_t nid = g->rank[r];
        codes[r] = g->code[nid];
        endmask[r] = g->out_e[nid].len == 0;
        IList *ie = &g->in_e[nid];
        int64_t penO, penF;
        if (ie->len == 0) {
            npred[r] = 1;
            preds[r * P] = 0;
            penO = pen_q - pen_c;
            penF = pen_g - pen_e;
        } else {
            npred[r] = ie->len;
            penO = penF = INT64_MIN;
            for (int32_t p = 0; p < ie->len; p++) {
                int32_t pi = id2rank[g->edges[ie->data[p]].begin] + 1;
                preds[r * P + p] = pi;
                if (O0[pi] > penO) penO = O0[pi];
                if (F0[pi] > penF) penF = F0[pi];
            }
        }
        O0[r + 1] = penO + pen_c;
        F0[r + 1] = penF + pen_e;
    }
    free(id2rank);
}

/* graph.cpp:494-586 — heaviest bundle + branch completion. */
static int32_t branch_completion(PoaGraph *g, int64_t *scores,
                                 int32_t *pred, int32_t rank) {
    int32_t nid0 = g->rank[rank];
    IList *oe = &g->out_e[nid0];
    for (int32_t i = 0; i < oe->len; i++) {
        int32_t end = g->edges[oe->data[i]].end;
        IList *ie = &g->in_e[end];
        for (int32_t k = 0; k < ie->len; k++) {
            int32_t b = g->edges[ie->data[k]].begin;
            if (b != nid0) scores[b] = -1;
        }
    }
    int64_t max_score = 0;
    int32_t max_id = 0;
    for (int32_t i = rank + 1; i < g->n_rank; i++) {
        int32_t nid = g->rank[i];
        scores[nid] = -1;
        pred[nid] = -1;
        IList *ie = &g->in_e[nid];
        for (int32_t k = 0; k < ie->len; k++) {
            PoaEdge *e = &g->edges[ie->data[k]];
            if (scores[e->begin] == -1) continue;
            if (scores[nid] < e->weight
                || (scores[nid] == e->weight
                    && scores[pred[nid]] <= scores[e->begin])) {
                scores[nid] = e->weight;
                pred[nid] = e->begin;
            }
        }
        if (pred[nid] != -1) scores[nid] += scores[pred[nid]];
        if (max_score < scores[nid]) {
            max_score = scores[nid];
            max_id = nid;
        }
    }
    return max_id;
}

int64_t poa_consensus(void *h, uint8_t *out, int64_t cap) {
    PoaGraph *g = (PoaGraph *)h;
    int32_t n = g->n_nodes;
    if (n == 0) return 0;
    int32_t *pred = (int32_t *)malloc((size_t)n * 4);
    int64_t *scores = (int64_t *)malloc((size_t)n * 8);
    for (int32_t i = 0; i < n; i++) { pred[i] = -1; scores[i] = -1; }
    int32_t max_id = 0;
    for (int32_t r = 0; r < g->n_rank; r++) {
        int32_t nid = g->rank[r];
        IList *ie = &g->in_e[nid];
        for (int32_t k = 0; k < ie->len; k++) {
            PoaEdge *e = &g->edges[ie->data[k]];
            if (scores[nid] < e->weight
                || (scores[nid] == e->weight
                    && scores[pred[nid]] <= scores[e->begin])) {
                scores[nid] = e->weight;
                pred[nid] = e->begin;
            }
        }
        if (pred[nid] != -1) scores[nid] += scores[pred[nid]];
        if (scores[max_id] < scores[nid]) max_id = nid;
    }
    if (g->out_e[max_id].len) {
        int32_t *id2rank = (int32_t *)calloc((size_t)n, 4);
        for (int32_t r = 0; r < g->n_rank; r++) id2rank[g->rank[r]] = r;
        while (g->out_e[max_id].len)
            max_id = branch_completion(g, scores, pred,
                                       id2rank[max_id]);
        free(id2rank);
    }
    /* walk back, emit reversed */
    int64_t m = 0;
    int32_t cur = max_id;
    while (pred[cur] != -1 && m < cap) { out[m++] = 0; cur = pred[cur]; }
    if (m < cap) m++;
    cur = max_id;
    for (int64_t i = m - 1; i >= 0; i--) {
        out[i] = g->code[cur];
        cur = pred[cur];
    }
    free(pred); free(scores);
    return m;
}
