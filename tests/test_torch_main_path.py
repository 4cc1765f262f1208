"""The port's main path end to end on the CPU: CR dict -> spec -> validate ->
compile_tables -> TorchClassifier(device="cpu").classify, against the JAX
package's TpuClassifier(force_path="dense") (Pallas in interpret mode) and
its scalar oracle.  Results, XDP verdicts and statistics must be
bit-identical."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from infw import compiler as jax_compiler
from infw import oracle as jax_oracle
from infw import spec as jax_spec
from infw import testing as jax_testing
from infw import validate as jax_validate
from infw.backend.tpu import TpuClassifier
from infw.interfaces import Interface as JaxInterface
from infw.interfaces import InterfaceRegistry as JaxRegistry
from infw.packets import make_batch
from infw_torch import compiler, spec, validate
from infw_torch.backend.cuda import TorchClassifier
from infw_torch.interfaces import Interface, InterfaceRegistry
from infw_torch.packets import PacketBatch

REPO = Path(__file__).resolve().parents[1]
BATCH_FIELDS = (
    "kind", "l4_ok", "ifindex", "ip_words", "proto", "dst_port",
    "icmp_type", "icmp_code", "pkt_len",
)
LINKS = (  # name, index, up, type, master
    ("eth0", 2, True, "device", None),
    ("eth1", 3, True, "device", "bond0"),
    ("eth2", 4, True, "device", "bond0"),
    ("bond0", 5, True, "bond", None),
    ("eth3", 6, False, "device", None),  # down: skipped, not an error
)


def registries():
    jr, pr = JaxRegistry(), InterfaceRegistry()
    for name, index, up, typ, master in LINKS:
        jr.add(JaxInterface(name=name, index=index, up=up, type=typ, master=master))
        pr.add(Interface(name=name, index=index, up=up, type=typ, master=master))
    return jr, pr


def rule(order, action, protocol="", **cfg):
    return {"order": order, "action": action,
            "protocolConfig": {"protocol": protocol, **cfg}}


def cr(name, interfaces, ingress):
    return {"metadata": {"name": name},
            "spec": {"nodeSelector": {"matchLabels": {"role": "worker"}},
                     "interfaces": interfaces, "ingress": ingress}}


CR_SETS = {
    "mixed": [
        cr("web", ["eth0"], [{
            "sourceCIDRs": ["10.0.0.0/8", "10.1.0.0/16", "10.1.2.3/32", "2001:db8::/32",
                            "2001:db8:aa::/48"],
            "rules": [
                rule(1, "Allow", "TCP", tcp={"ports": 80}),
                rule(2, "Deny", "TCP", tcp={"ports": "8000-9000"}),
                rule(3, "Allow", "UDP", udp={"ports": 53}),
                rule(4, "Deny", "SCTP", sctp={"ports": "9999-10010"}),
                rule(5, "Deny", "ICMP", icmp={"icmpType": 8, "icmpCode": 0}),
                rule(6, "Deny", "ICMPv6", icmpv6={"icmpType": 128, "icmpCode": 0}),
                rule(7, "Allow", "TCP", tcp={"ports": "1-1024"}),
                rule(50, "Deny"),
            ],
        }]),
        cr("infra", ["bond0", "eth3"], [{
            "sourceCIDRs": ["172.16.0.0/12", "172.16.5.0/24", "fd00::/8"],
            "rules": [
                rule(3, "Deny", "UDP", udp={"ports": "5000-6000"}),
                rule(9, "Allow", "ICMPv6", icmpv6={"icmpType": 135, "icmpCode": 0}),
                rule(20, "Allow"),
            ],
        }]),
    ],
    "catch_all_zero_prefix": [
        cr("default-deny", ["eth0", "bond0"], [{
            "sourceCIDRs": ["0.0.0.0/0", "::/0", "192.168.0.0/16"],
            "rules": [rule(1, "Allow", "TCP", tcp={"ports": 443}), rule(2, "Deny")],
        }]),
    ],
}

REJECTED = {
    "deny_ssh": [rule(1, "Deny", "TCP", tcp={"ports": 22})],
    "deny_etcd_range": [rule(1, "Deny", "TCP", tcp={"ports": "2000-3000"})],
    "deny_dhcp": [rule(4, "Deny", "UDP", udp={"ports": 68})],
    "bad_range": [rule(1, "Allow", "TCP", tcp={"ports": "90-80"})],
    "icmp_without_config": [rule(1, "Deny", "ICMP")],
    "duplicate_order": [rule(1, "Allow"), rule(1, "Deny")],
}


def pipelines(crs):
    """Both packages' spec -> validate -> compile_tables on the same dicts."""
    jr, pr = registries()
    jinfs = [jax_spec.IngressNodeFirewall.from_dict(d) for d in crs]
    pinfs = [spec.IngressNodeFirewall.from_dict(d) for d in crs]
    for i in range(len(crs)):
        assert jax_validate.validate_ingress_node_firewall(jinfs[i], jinfs[:i]) == []
        assert validate.validate_ingress_node_firewall(pinfs[i], pinfs[:i]) == []

    def iface_rules(infs):
        out = {}
        for inf in infs:
            for name in inf.spec.interfaces:
                out.setdefault(name, []).extend(inf.spec.ingress)
        return out

    jt = jax_compiler.compile_tables(iface_rules(jinfs), jr)
    pt = compiler.compile_tables(iface_rules(pinfs), pr)
    return jt, pt


def port_batch(batch):
    return PacketBatch(**{f: getattr(batch, f) for f in BATCH_FIELDS})


def traffic(jt, seed):
    rng = np.random.default_rng(seed)
    b = jax_testing.random_batch(rng, jt, n_packets=300, ifindexes=(2, 3, 4, 6))
    hand = make_batch(
        src=["10.1.2.3", "10.1.2.3", "10.9.9.9", "2001:db8:aa::1", "172.16.5.9",
             "fd00::5", "8.8.8.8", "2001:db8::7", "10.1.0.1"],
        proto=[6, 6, 17, 58, 17, 58, 6, 132, 1],
        dst_port=[80, 8500, 53, 0, 5500, 0, 443, 10000, 0],
        icmp_type=[0, 0, 0, 128, 0, 135, 0, 0, 8],
        ifindex=[2, 2, 2, 2, 3, 4, 2, 2, 2],
        pkt_len=[60, 1500, 90, 1280, 400, 72, 9000, 300, (1 << 21) - 1],
    )
    from infw.packets import concat
    return concat([b, hand])


@pytest.mark.parametrize("name", sorted(CR_SETS))
def test_main_path_matches_jax_and_oracle(name):
    jt, pt = pipelines(CR_SETS[name])
    batch = traffic(jt, seed=len(name))
    ref = jax_oracle.classify(jt, batch)

    jclf = TpuClassifier(force_path="dense")
    jclf.load_tables(jt)
    jout = jclf.classify(batch)
    clf = TorchClassifier(device="cpu")
    clf.load_tables(pt)
    assert clf.active_path == "dense"
    out = clf.classify(port_batch(batch))

    np.testing.assert_array_equal(out.results, jout.results)
    np.testing.assert_array_equal(out.xdp, jout.xdp)
    np.testing.assert_array_equal(out.stats_delta, jout.stats_delta)
    np.testing.assert_array_equal(out.results, ref.results)
    np.testing.assert_array_equal(out.xdp, ref.xdp)
    assert jax_testing.stats_dict_from_array(out.stats_delta) == ref.stats
    np.testing.assert_array_equal(clf.stats.snapshot(), out.stats_delta)
    assert (out.results != 0).sum() > 50


@pytest.mark.parametrize("v4_only", [False, True])
def test_main_path_wire_widths(v4_only):
    """v4-only chunks ship the 4/3-word wire, mixed ones the 7/6-word wire;
    wide ifindexes keep the full-width form.  All must agree with JAX."""
    rng = np.random.default_rng(21)
    jt = jax_testing.random_tables(rng, n_entries=30, width=10)
    batch = jax_testing.random_batch(rng, jt, n_packets=400)
    if v4_only:
        batch = batch.take(np.nonzero(batch.kind != 2)[0])
        batch.ip_words[:, 1:] = 0
    for wide in (False, True):
        if wide:
            batch.pkt_len[::5] = 70000  # disqualifies the narrow form
        jclf = TpuClassifier(force_path="dense")
        jclf.load_tables(jt)
        clf = TorchClassifier(device="cpu")
        clf.load_tables(compiler.compile_tables_from_content(
            {compiler.LpmKey(*k): v for k, v in jt.content.items()}, rule_width=10))
        jout, out = jclf.classify(batch), clf.classify(port_batch(batch))
        for f in ("results", "xdp", "stats_delta"):
            np.testing.assert_array_equal(getattr(out, f), getattr(jout, f), err_msg=f)


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_validation_rejects_like_jax(case):
    d = cr("bad", ["eth0"], [{"sourceCIDRs": ["192.0.2.0/24"], "rules": REJECTED[case]}])
    want = jax_validate.validate_ingress_node_firewall(jax_spec.IngressNodeFirewall.from_dict(d))
    got = validate.validate_ingress_node_firewall(spec.IngressNodeFirewall.from_dict(d))
    assert want and got == want


def test_validation_cross_object_order_overlap():
    a = cr("a", ["eth0"], [{"sourceCIDRs": ["10.0.0.0/8"], "rules": [rule(1, "Allow")]}])
    b = cr("b", ["eth0"], [{"sourceCIDRs": ["10.0.0.0/8"], "rules": [rule(1, "Deny")]}])
    want = jax_validate.validate_ingress_node_firewall(
        jax_spec.IngressNodeFirewall.from_dict(b), [jax_spec.IngressNodeFirewall.from_dict(a)])
    got = validate.validate_ingress_node_firewall(
        spec.IngressNodeFirewall.from_dict(b), [spec.IngressNodeFirewall.from_dict(a)])
    assert want and got == want


@pytest.mark.parametrize("name", sorted(CR_SETS))
def test_compile_tables_rows_match_jax(name):
    """Row for row: both compilers keep each masked identity at its first
    occurrence with the last writer's value, and build_table_content walks
    the same dict order, so the JAX row order is reproducible."""
    jt, pt = pipelines(CR_SETS[name])
    assert (pt.num_entries, pt.rule_width) == (jt.num_entries, jt.rule_width)
    for f in ("key_words", "mask_words", "mask_len", "rules"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(jt, f), err_msg=f)
    assert {tuple(k): v.tolist() for k, v in pt.content.items()} == {
        tuple(k): v.tolist() for k, v in jt.content.items()
    }


def test_compile_from_content_aliasing_matches_jax():
    """Keys that alias under their mask collapse to one entry: first
    position, last writer's rules — row for row as the JAX compiler."""
    rng = np.random.default_rng(5)
    keys = [
        (40, 2, bytes([10, 1]) + bytes(14)),
        (40, 2, bytes([10, 9, 9, 9]) + bytes(12)),      # aliases the first
        (64, 3, bytes([192, 0, 2, 1]) + bytes(12)),
        (32, 2, bytes([1, 2, 3, 4]) + bytes(12)),       # /0
        (32, 2, bytes(16)),                              # aliases the /0
        (160, 2, bytes(range(16))),
    ]
    rows = [jax_testing.random_rules(rng, 6) for _ in keys]
    jt = jax_compiler.compile_tables_from_content(
        {jax_compiler.LpmKey(*k): r for k, r in zip(keys, rows)}, rule_width=6)
    pt = compiler.compile_tables_from_content(
        {compiler.LpmKey(*k): r for k, r in zip(keys, rows)}, rule_width=6)
    assert pt.num_entries == jt.num_entries == 4
    for f in ("key_words", "mask_words", "mask_len", "rules"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(jt, f), err_msg=f)


def test_port_generators_match_jax():
    """One seed, the same tables and batch on both sides."""
    from infw_torch import testing

    jt = jax_testing.random_tables(np.random.default_rng(3), 25, width=9)
    pt = testing.random_tables(np.random.default_rng(3), 25, width=9)
    for f in ("key_words", "mask_words", "mask_len", "rules"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(jt, f), err_msg=f)
    jb = jax_testing.random_batch_fast(np.random.default_rng(4), jt, 500)
    pb = testing.random_batch_fast(np.random.default_rng(4), pt, 500)
    for f in BATCH_FIELDS:
        np.testing.assert_array_equal(getattr(pb, f), getattr(jb, f), err_msg=f)


def test_default_device_is_cuda_or_raises():
    if torch.cuda.is_available():
        assert TorchClassifier().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchClassifier()


def _content(n, rid=1, width=4):
    rows = np.zeros((width, 7), np.int32)
    rows[1] = [rid, 6, 80, 0, 0, 0, 1]
    return {compiler.LpmKey(64, 2, i.to_bytes(4, "big") + bytes(12)): rows for i in range(n)}


@pytest.mark.parametrize("case", ["entries", "rule_id", "rule_width"])
def test_load_tables_routes_to_the_trie_path(case):
    """What the dense packing cannot hold (more than 4096 entries, ruleIds
    above 127, rule width above 128) loads on the trie path and classifies
    as the oracle does."""
    from infw_torch import oracle
    from infw_torch.packets import make_batch as port_make_batch

    content, width = {
        "entries": (_content(4097), 4),
        "rule_id": (_content(3, rid=200), 4),
        "rule_width": (_content(3, width=130), 130),
    }[case]
    tables = compiler.compile_tables_from_content(content, rule_width=width)
    clf = TorchClassifier(device="cpu")
    clf.load_tables(tables)
    assert clf.active_path == "trie"
    batch = port_make_batch(
        src=["0.0.0.1", "0.0.2.255", "0.0.16.0", "0.0.0.2", "2001:db8::1"],
        proto=[6, 6, 6, 17, 6], dst_port=[80, 80, 80, 80, 80], ifindex=[2, 2, 2, 2, 2],
    )
    out = clf.classify(batch)
    ref = oracle.classify(tables, batch)
    np.testing.assert_array_equal(out.results, ref.results)
    np.testing.assert_array_equal(out.xdp, ref.xdp)
    assert out.results[0] == (content[next(iter(content))][1, 0] << 8) | 1


def test_load_tables_refuses_an_overlay():
    clf = TorchClassifier(device="cpu")
    main = compiler.compile_tables_from_content(_content(3))
    with pytest.raises(ValueError, match="overlay"):
        clf.load_tables(main, overlay=compiler.compile_tables_from_content(_content(1)))
    clf.load_tables(main, overlay=compiler.compile_tables_from_content({}))
    assert clf.active_path == "dense"


def test_trie_path_overlay_is_not_implemented():
    """The trie and ctrie paths' overlay combine comes with incremental
    loads."""
    main = compiler.compile_tables_from_content(_content(3))
    for path in ("trie", "ctrie"):
        clf = TorchClassifier(device="cpu", force_path=path)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            clf.load_tables(main, overlay=compiler.compile_tables_from_content(_content(1)))
        assert clf.active_path is None
        clf.load_tables(main, overlay=compiler.compile_tables_from_content({}))
        assert clf.active_path == path
    with pytest.raises(ValueError, match="force_path"):
        TorchClassifier(device="cpu", force_path="arena")


@pytest.mark.parametrize("fn_name", ["build_dense_tables", "device_batch", "build_trie_tables"])
def test_device_operands_default_to_the_card(fn_name):
    """The functions that put tables and batches on a device take the
    classifier's device rule: no device means the first CUDA card, and
    without one they raise; the CPU only when named."""
    from infw_torch import packets as port_packets
    from infw_torch.kernels import dense, torchpath, walk

    tables = compiler.compile_tables_from_content(_content(3))
    fn, arg = {
        "build_dense_tables": (dense.build_dense_tables, tables),
        "device_batch": (torchpath.device_batch, port_packets.make_batch(src=["0.0.0.1"], proto=[6], ifindex=[2])),
        "build_trie_tables": (walk.build_trie_tables, tables),
    }[fn_name]
    if torch.cuda.is_available():
        assert fn(arg)[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(arg)
    assert fn(arg, "cpu")[0].device.type == "cpu"


def test_import_loads_no_jax_and_no_infw():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('infw_torch.kernels.wire_decode', 'infw_torch.backend.cuda',\n"
        "             'infw_torch.kernels.cwalk', 'infw_torch'):\n"
        "    importlib.import_module(name)\n"
        "    bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'infw')]\n"
        "    assert not bad, (name, bad)\n"
        "import infw_torch\n"
        "for m in pkgutil.walk_packages(infw_torch.__path__, 'infw_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'infw')]\n"
        "print(len([m for m in sys.modules if m.startswith('infw_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 15
