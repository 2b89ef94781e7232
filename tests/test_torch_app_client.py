"""The port's client (gpu_docker_api_tpu_torch/client.py) driving the
port's daemon, against the JAX client driving the JAX App: every client
case of tests/test_openapi.py, run on both packages and held envelope by
envelope (tests/torch_app_twins.py says how, and what is normalised). The
JAX cases' app fixture makes its state dir with tempfile; here it lives
under the case's tmp_path, so that both variants' directories normalise.

Then the document each daemon serves: the port's serves JAX's whole
api/openapi.json, every route of it is served, and the fleet, placement
and defrag routes (the planes the port served last) answer as the JAX
daemon's do. Last, federation's watch half and the client's list+watch and
Informer against JAX's on the same calls (the twins of every case of
tests/test_federation.py are tests/test_torch_federation.py)."""

import http.client
import json
import os
import time

import pytest
import torch

from gpu_docker_api_tpu.server.app import App as JApp
from gpu_docker_api_tpu_torch.client import ApiClient
from gpu_docker_api_tpu_torch.server.app import App
from torch_app_twins import Norm, line, twin_tests

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLIENT_CASES = (
    "test_generated_client_drives_the_server",
    "test_client_validates_before_the_wire",
    "test_client_surfaces_envelope_errors",
    "test_client_drives_health_cordon_drain",
    "test_client_retries_idempotent_gets",
    "test_client_keepalive_pools_connection",
    "test_client_stale_pooled_socket_retried",
)

globals().update(twin_tests("test_openapi", select=CLIENT_CASES, patches=(
    ('''def app():
    d = tempfile.mkdtemp(prefix="tdapi-oapi-")''', '''def app(tmp_path):
    d = str(tmp_path / "tdapi-oapi")'''),
)))


@pytest.fixture()
def apps(tmp_path):
    made = []
    for cls, pkg in ((JApp, "jax"), (App, "torch")):
        a = cls(state_dir=str(tmp_path / pkg), backend="mock",
                addr="127.0.0.1:0", topology=line(pkg, 4), api_key="",
                cpu_cores=8)
        a.start()
        made.append(a)
    yield made
    for a in made:
        a.stop()


#: the fleet, placement and defrag routes: (METHOD, route) -> a body
FLEET_ROUTES = {
    ("POST", "/api/v1/fleet/lease"): {"member": "m0", "addr": "10.0.0.9:1"},
    ("POST", "/api/v1/fleet/lease/:member/renew"): None,
    ("DELETE", "/api/v1/fleet/lease/:member"): None,
    ("GET", "/api/v1/fleet/members"): None,
    ("GET", "/api/v1/fleet/grants"): None,
    ("POST", "/api/v1/fleet/grants"): {"resource": "containers",
                                       "name": "g0", "member": "m0"},
    ("POST", "/api/v1/fleet/grants/release"): {
        "resource": "containers", "name": "g0", "member": "m0"},
    ("GET", "/api/v1/placement"): None,
    ("POST", "/api/v1/placement/defrag"): {"tpuCount": 2},
}


def test_served_spec_describes_exactly_the_served_routes(apps):
    japp, tapp = apps
    routes = set(tapp.server.router.routes())
    assert routes == set(japp.server.router.routes())
    c = ApiClient("127.0.0.1", tapp.server.port)
    with open(os.path.join(REPO, "api", "openapi.json"),
              encoding="utf-8") as f:
        doc = json.load(f)
    assert c.spec == doc
    described = set()
    for path, item in c.spec["paths"].items():
        route = path.replace("{", ":").replace("}", "")
        described |= {(m.upper(), route) for m in item
                      if m in ("get", "post", "patch", "delete")}
    assert described <= routes
    assert set(FLEET_ROUTES) <= described
    for op in ("fleetJoin", "fleetRenew", "fleetLeave", "fleetMembers",
               "fleetGrants", "fleetAcquire", "fleetRelease",
               "getPlacement", "runDefrag", "createGateway",
               "listGateways", "getGateway", "deleteGateway",
               "scaleGateway", "gatewayGenerate"):
        getattr(c, op)                   # every plane is served
    for helper in ("placement_status", "defrag_status", "run_defrag"):
        assert callable(getattr(c, helper))
    c.close()


@pytest.mark.parametrize("method,route", sorted(FLEET_ROUTES))
def test_every_fleet_and_placement_route_answers_as_the_jax_daemon(
        apps, method, route, tmp_path):
    """Each route the port answered with a refusal until it served the
    fleet, placement and defrag planes: the port's daemon answers the
    request (and the same request again, as a retry would) with the JAX
    daemon's status and envelope, normalised as the twins normalise."""
    body = FLEET_ROUTES[(method, route)]
    path = route.replace(":member", "m0")
    got = []
    for app, pkg in zip(apps, ("jax", "torch")):
        norm = Norm(pkg, str(tmp_path / pkg))
        answers = []
        for _ in range(2):
            conn = http.client.HTTPConnection("127.0.0.1", app.server.port,
                                              timeout=10)
            conn.request(method, path,
                         json.dumps(body) if body is not None else None,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            answers.append((resp.status, norm(json.loads(resp.read()))))
            conn.close()
        got.append(answers)
    assert got[1] == got[0]
    assert all(status == 200 for status, _ in got[1])


# ---- federation's watch half and the client's list+watch ------------------
# (restated from tests/test_federation.py's watch cases on the same calls;
# tests/test_torch_federation.py twins the cases themselves)

def _watch_pkg(pkg):
    import importlib
    root = "gpu_docker_api_tpu" if pkg == "jax" else "gpu_docker_api_tpu_torch"
    return (importlib.import_module(f"{root}.federation"),
            importlib.import_module(f"{root}.store.mvcc"),
            importlib.import_module(f"{root}.client"))


def _feed(pkg):
    fed, mvcc, _ = _watch_pkg(pkg)
    hub = fed.WatchHub()
    store = fed.WatchedStore(mvcc.MVCCStore(), hub)
    base = fed.ResourcePrefix.Base
    keys = [f"{base}/containers/rs-0", f"{base}/gateways/gw",
            f"{fed.FLEET_PREFIX}/grants/containers:rs-0",
            f"{base}/versions/rs-0/1", "/elsewhere/entirely"]
    parsed = [fed.parse_watch_key(k) for k in keys]
    r1 = store.put(f"{base}/containers/a", "1")
    r2 = store.put_many([(f"{base}/containers/b", "2"),
                         (f"{base}/containers/c", "3")])
    store.delete(f"{base}/containers/a")
    feed = hub.events_since(0)
    resumed = hub.events_since(r2)
    rev, items = store.list_snapshot("containers")
    small = fed.WatchHub(capacity=16)
    churn = fed.WatchedStore(mvcc.MVCCStore(), small)
    for i in range(40):
        churn.put(f"{base}/containers/rs-{i}", str(i))
    with pytest.raises(fed.WatchCompactedError) as ei:
        small.events_since(0)
    return (parsed, (r1, r2), feed, resumed, rev, items, small.floor,
            small.head, ei.value.floor,
            [e["revision"] for e in small.events_since(small.floor)])


def test_watch_hub_and_watched_store_equal_the_jax_ones():
    assert _feed("torch") == _feed("jax")


def _watch_http(app, pkg, make_rs):
    _, _, client = _watch_pkg(pkg)
    c = client.ApiClient("127.0.0.1", app.server.port, spec={"paths": {}})
    rev0, items0 = c.list_resource("containers")
    make_rs("wa")
    make_rs("wb")
    stream = c.watch("containers", from_revision=rev0, heartbeat=0.2)
    seen = [next(stream), next(stream)]
    stream.close()
    rev1, items1 = c.list_resource("containers")
    app.hub.capacity = 16
    base = "/tpu-docker-api/apis/v1"
    for i in range(40):
        app.store.put(f"{base}/containers/x{i}", "{}")
    refusals = []
    for frm in (app.hub.floor - 1, app.hub.head + 1000):
        with pytest.raises(client.RelistRequiredError) as ei:
            next(c.watch("containers", from_revision=frm))
        refusals.append(ei.value.floor == app.hub.floor)
    inf = client.Informer([("127.0.0.1", app.server.port)], "containers",
                          heartbeat=0.2)
    inf.start()
    try:
        make_rs("infa")
        deadline = time.monotonic() + 30
        while "infa" not in inf.snapshot()[1]:
            assert time.monotonic() < deadline, "the informer never caught up"
            time.sleep(0.02)
        cache = inf.snapshot()[1]
        ordered = inf.revisions == sorted(set(inf.revisions))
        relists = inf.relists
    finally:
        inf.stop()
    return {"items0": items0, "seen": sorted(e["name"] for e in seen),
            "in_order": [e["revision"] for e in seen] == sorted(
                e["revision"] for e in seen) and seen[0]["revision"] > rev0,
            "snapshot": sorted(i["name"] for i in items1),
            "resumes_after": rev1 >= seen[-1]["revision"],
            "refusals": refusals, "informer": sorted(cache),
            "ordered": ordered, "relists": relists}


def test_list_watch_and_the_informer_equal_the_jax_ones(apps):
    got = []
    for app, pkg in zip(apps, ("jax", "torch")):
        def make_rs(name, app=app):
            conn = http.client.HTTPConnection("127.0.0.1", app.server.port,
                                              timeout=10)
            conn.request("POST", "/api/v1/replicaSet", json.dumps({
                "imageName": "i", "replicaSetName": name, "tpuCount": 1}),
                {"Content-Type": "application/json"})
            assert json.loads(conn.getresponse().read())["code"] == 200
            conn.close()
        got.append(_watch_http(app, pkg, make_rs))
    assert got[1] == got[0]
    assert got[1]["seen"] == ["wa", "wb"] and len(got[1]["refusals"]) == 2
    assert "infa" in got[1]["informer"] and got[1]["relists"] == 1
