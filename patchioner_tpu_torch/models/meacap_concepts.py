"""MeaCap's concept extraction: the scene-graph merge, host Python.

Twin of `patchioner_tpu/models/meacap_concepts.py` (reference
src/meacap/utils/parse_tool.py and detect_utils.py:20-43), over numpy
only. A sample's retrieved memory captions become at most 4 key
concepts:
1. each caption is parsed into a scene-graph string "( s , r , o ) , ( s ,
   a )" by a model the caller supplies (`parse_fn`; flan-T5 in the
   reference);
2. one graph per caption, merged into a global graph with per-entity
   counts (`build_graph_dict`);
3. entities whose sentence embeddings (`encode_fn`; SentenceBERT) have a
   cosine above 0.55 are merged into a representative, and an entity
   whose merged count is 2 or less is dropped (`merge_graph_entities`);
4. the survivors are ordered by where they sit in the captions, and one
   attribute is attached where its merged count reaches 3
   (`order_and_attach`);
5. the first 4 are the concepts (`concepts_from_graphs`,
   `retrieve_concepts`).
The reference's quirks are kept, each marked `quirk:` with its
parse_tool.py line; the JAX module documents the same ones at the lines
cited with each function.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["split_graph_segments", "build_graph_dict", "merge_graph_entities",
           "order_and_attach", "concepts_from_graphs", "retrieve_concepts"]

# parse_tool.py:7: a digit object of an (s, is, digit) triple is spelled out
_DIGIT_WORDS = dict(zip("23456789", ("two", "three", "four", "five", "six", "seven",
                                     "eight", "nine")))
SIMILARITY_THRESHOLD = 0.55  # parse_tool.py:120
MIN_COUNT = 2                # parse_tool.py:159: an entity survives iff count > 2
ATTRIBUTE_THRESHOLD = 3      # parse_tool.py:18


def _by_count(counts) -> "OrderedDict[str, int]":
    """Entities by count, highest first; equal counts keep their order."""
    return OrderedDict(sorted(counts.items(), key=lambda kv: kv[1], reverse=True))


def split_graph_segments(graphs) -> List[List[str]]:
    """Each graph's segments "s , r , o" / "s , a", parens stripped (JAX
    meacap_concepts.py:58; parse_tool.py:226-252): the spacing
    normalised, then split at ") , (". One string is one graph; anything
    but a string, list or tuple raises ValueError (a bare string iterated
    would shred into characters)."""
    if isinstance(graphs, str):
        graphs = [graphs]
    if not isinstance(graphs, (list, tuple)):
        raise ValueError(f"graphs must be str or list, got {type(graphs)}")
    out = []
    for graph in graphs:
        for mark in "(),":
            graph = graph.replace(mark, f" {mark} ")
        graph = " ".join(graph.split())
        out.append([seg.replace("(", "").replace(")", "").strip()
                    for seg in graph.split(") , (")])
    return out


def _new_node() -> dict:
    return {"Relation": {}, "Attribute": {}, "count": 1}


def _add_edge(graph: dict, subject: str, edge: list) -> None:
    """The node `subject`, with one edge: [object, relation], [attribute]
    or none (parse_tool.py:178-208 `add_node_graph`).

    quirk (parse_tool.py:184): adding to a node that exists never bumps its
    count; a caption's graph counts each entity once, and counting across
    captions happens in the merge.
    quirk (parse_tool.py:203): adding an attribute sets its count to 1,
    even where the node had it, so one caption counts it once.
    """
    if len(edge) > 2:
        raise KeyError(f"{edge} is wrong")
    fresh = subject not in graph
    node = graph.setdefault(subject, _new_node())
    if len(edge) == 2:
        obj, rel = edge
        if fresh or obj not in node["Relation"]:
            node["Relation"][obj] = [rel]
        else:
            node["Relation"][obj] += [rel]  # extended in place, as the reference
    elif len(edge) == 1:
        node["Attribute"][edge[0]] = 1


def _fold(into: dict, node: dict) -> None:
    """`node`'s relations, count and attributes into `into`.

    quirk (parse_tool.py:213, and :9-16 for merged entities): the relation
    dict is `update`d, so an object both carry takes `node`'s list, while
    counts and attribute counts add up."""
    into["Relation"].update(node["Relation"])
    into["count"] += node["count"]
    for attr, n in node["Attribute"].items():
        into["Attribute"][attr] = into["Attribute"].get(attr, 0) + n


def build_graph_dict(graphs: Sequence[str], type_dict: Optional[dict] = None,
                     attribute_dict: Optional[dict] = None
                     ) -> Tuple[List[str], "OrderedDict[str, int]", dict]:
    """(entities by count, highest first; their counts; the merged global
    graph) of the per-caption graphs (JAX meacap_concepts.py:135;
    parse_tool.py:345-430 `get_graph_dict`). `type_dict` and
    `attribute_dict` are filled as the reference fills them.

    A segment of one field is a bare object, and only when it is its
    graph's only segment (quirk, parse_tool.py:358: otherwise it is
    dropped); two fields (s, a) an attribute; three (s, is, o) the
    attribute o of s, a digit spelled out; three (s, r, o) a relation; more
    than three a relation whose label is the list of the middle fields.
    quirk (parse_tool.py:415): a caption's entities are counted through
    `list(set(...))`, so the order of equal counts follows the set's order,
    as in the reference.
    """
    type_dict = {} if type_dict is None else type_dict
    attribute_dict = {} if attribute_dict is None else attribute_dict
    counts: "OrderedDict[str, int]" = OrderedDict()
    merged: dict = {}

    def attribute(subj, attr, seen, graph):
        type_dict[f"{attr} {subj}"] = "attribute"
        seen.append(subj)
        type_dict[subj] = "object"
        attribute_dict.setdefault(subj, []).append(attr)
        _add_edge(graph, subj, [attr])

    def relation(subj, label, obj, fact, seen, graph):
        type_dict[fact] = "fact"
        for ent in (subj, obj):
            seen.append(ent)
            type_dict[ent] = "object"
        _add_edge(graph, subj, [obj, label])
        _add_edge(graph, obj, [])

    for segments in split_graph_segments(graphs):
        seen: List[str] = []
        graph: dict = {}
        for seg in segments:
            fields = [f.strip() for f in seg.split(",")]
            if len(fields) == 1:
                if len(segments) == 1:
                    seen.append(fields[0])
                    type_dict[fields[0]] = "object"
                    _add_edge(graph, fields[0], [])
            elif len(fields) == 2:
                attribute(fields[0], fields[1], seen, graph)
            elif len(fields) == 3 and fields[1] == "is":
                attribute(fields[0], _DIGIT_WORDS.get(fields[2], fields[2]), seen, graph)
            elif len(fields) == 3:
                subj, rel, obj = fields
                obj = _DIGIT_WORDS.get(obj, obj)
                relation(subj, rel, obj, f"{subj} {rel} {obj}", seen, graph)
            else:
                # quirk (parse_tool.py:405): the fact's key runs subject, the
                # joined middle fields and object together without spaces
                relation(fields[0], fields[1:-1], fields[-1],
                         fields[0] + " ".join(fields[1:-1]) + fields[-1], seen, graph)
        for ent in list(set(seen)):
            counts[ent] = counts.get(ent, 0) + 1
        for key, node in graph.items():  # parse_tool.py:210-222
            if key in merged:
                _fold(merged[key], node)
            else:
                merged[key] = node
    ranked = _by_count(counts)
    return list(ranked), ranked, merged


def merge_graph_entities(embeddings: np.ndarray, entities: List[str],
                         counts: "OrderedDict[str, int]", global_graph: dict):
    """Merge entities whose embeddings' cosine exceeds 0.55 and drop those
    of count 2 or less (JAX meacap_concepts.py:230; parse_tool.py:114-163
    `merge_graph_dict` up to its ordering): (survivors by count, their
    subgraph, kept -> absorbed, removed -> representative).

    `embeddings` (len(entities), D) are normalised here (the reference
    encodes with `normalize_embeddings=True`). Ordered pairs (x, y) above
    the threshold, the diagonal excluded, are taken row-major as
    `torch.where` gives them:
    - an x not yet absorbed keeps y: counts[x] += counts[y], y's count as
      it stands then, maybe already grown;
    - an x already absorbed records y as a neighbour instead, from which
      its representative is picked;
    - quirk (parse_tool.py:144): y's node is folded into x's for every
      pair, absorbed x or not, so a symmetric pair folds both ways.
    Every absorbed entity is removed and mapped to its first neighbour
    still alive; quirk (parse_tool.py:152-156): one with no such
    neighbour prints "remove wrong!" and gets no mapping.
    """
    counts = OrderedDict(counts)
    if entities:
        e = np.asarray(embeddings, dtype=np.float32)
        e = e / np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-12)
        sim = e @ e.T
        np.fill_diagonal(sim, 0.0)
        pairs = np.argwhere(sim > SIMILARITY_THRESHOLD)
    else:
        pairs = np.zeros((0, 2), dtype=np.int64)

    kept: Dict[str, List[str]] = {}
    neighbours: Dict[str, List[str]] = {}
    absorbed: List[str] = []
    for x, y in pairs.tolist():
        ex, ey = entities[x], entities[y]
        if ex in absorbed:
            neighbours.setdefault(ex, []).append(ey)
        else:
            kept.setdefault(ex, []).append(ey)
            counts[ex] += counts[ey]
        if ey not in kept:
            absorbed.append(ey)
        _fold(global_graph[ex], global_graph[ey])

    removed = [ent for group in kept.values() for ent in group]
    representative: Dict[str, str] = {}
    for gone in removed:
        alive = [w for w in neighbours.get(gone, []) if w not in removed]
        if alive:
            representative[gone] = alive[0]
        else:
            print("remove wrong!")  # parse_tool.py:156, verbatim
    survivors = OrderedDict((ent, n) for ent, n in counts.items()
                            if ent not in removed and n > MIN_COUNT)
    subgraph = {ent: global_graph[ent] for ent in survivors}
    return _by_count(survivors), subgraph, kept, representative


def order_and_attach(subgraph: dict, representative: Dict[str, str],
                     sentences: Sequence[str],
                     attribute_thresh: int = ATTRIBUTE_THRESHOLD):
    """(the rated nodes in order, the concepts): relations re-wired through
    `representative`, each node placed at the mean of its relative
    positions in `sentences`, and an entity's first attribute of merged
    count >= `attribute_thresh` put before it (JAX meacap_concepts.py:312;
    parse_tool.py:18-76 `filter_relation`).

    quirk (parse_tool.py:24-26): a position of 0 (the caption starts with
    the entity) counts as absent, as find()'s -1 does; a node never found
    past the start gets position 1 and goes last.
    quirk (parse_tool.py:37-51): the first relation onto a target shares
    the subgraph's list; a second onto the same target (direct and
    re-wired) extends that list in place.
    """
    nodes = list(subgraph)
    rated: Dict[str, dict] = {}
    for node in nodes:
        found = [p for p in (s.find(node) / len(s) for s in sentences) if p > 0]
        info = rated.setdefault(node, {"rating": 0})
        info["relative_pos"] = float(np.mean(found)) if found else 1
        info["Attribute"] = subgraph[node]["Attribute"]
        info["count"] = subgraph[node]["count"]
        info["Relation"] = {}
        for obj, rels in subgraph[node]["Relation"].items():
            target = obj if obj in nodes else representative.get(obj)
            if target not in nodes:
                continue
            if target in info["Relation"]:
                info["Relation"][target] += rels
            else:
                info["Relation"][target] = rels
            if target in rated:
                rated[target]["rating"] += 1
            else:
                rated[target] = {"rating": 1}
            info["rating"] += 2
    ordered = OrderedDict(sorted(rated.items(), key=lambda kv: kv[1]["relative_pos"]))
    concepts = []
    for ent, info in ordered.items():
        attr = next((a for a, n in info["Attribute"].items() if n >= attribute_thresh), None)
        concepts.append(ent if attr is None else f"{attr} {ent}")
    return ordered, concepts


def concepts_from_graphs(graphs: Sequence[str], encode_fn: Callable[[Sequence[str]], np.ndarray],
                         sentences: Sequence[str], max_concepts: int = 4) -> List[str]:
    """Scene-graph strings -> at most `max_concepts` ordered concepts
    (JAX meacap_concepts.py:374; detect_utils.py:27-43). `encode_fn(texts)
    -> (N, D)` stands for SentenceBERT; `sentences` are the memory captions
    the positions are read in. No entity, or no survivor
    (parse_tool.py:163-168), gives no concept."""
    entities, counts, merged = build_graph_dict(graphs)
    if not entities:
        return []
    _, subgraph, _, representative = merge_graph_entities(
        np.asarray(encode_fn(entities)), entities, counts, merged)
    if not subgraph:
        return []
    return order_and_attach(subgraph, representative, sentences)[1][:max_concepts]


def retrieve_concepts(captions: Sequence[str], parse_fn: Callable[[Sequence[str]], List[str]],
                      encode_fn: Callable[[Sequence[str]], np.ndarray],
                      max_concepts: int = 4) -> List[str]:
    """One sample's memory captions -> its concepts: parse, merge, order
    (JAX meacap_concepts.py:396; detect_utils.py:20-43)."""
    return concepts_from_graphs(parse_fn(captions), encode_fn, captions, max_concepts)
