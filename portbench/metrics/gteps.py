"""``gteps``: billions of edges traversed a second, Graph500 / GAP style.

The TEPS count of every query completed in the window (the undirected
edges of each source's component; pagerank: the graph's undirected edges
times the rounds it ran) over the whole window, first dispatch to the
end of the last query.  Host clock."""


def read(run):
    return sum(q.edges for q in run.queries) / run.window_s / 1e9
