"""The port's reference-checkpoint converter (speech_recognition_tpu_torch/compat/)
against TensorFlow and the JAX package, and the port's remote storage helpers
and remote TensorBoard writer against a fake GCS server, on the CPU.

- Reader: JAX ``save_tf_checkpoint`` (through TensorFlow) writes the LAS and
  DeepSpeech2 mini configs' seeded weights; the port's ``convert_tf_checkpoint``
  equals JAX's leaf for leaf, bit for bit, from the prefix and from its
  directory, and ``bundle_keys`` gives TensorFlow's dtypes and shapes.
- Model: ``load_tf_checkpoint`` gives the ``state_dict`` of
  ``params_from_jax``; eval logits match the JAX model's (LAS rtol 1e-4 /
  atol 1e-5 as tests/test_torch_las.py, DS2 atol 1e-5 as tests/test_torch_ds2.py).
- Writer: TensorFlow reads ``export_tf_checkpoint``'s keys, dtypes, shapes and
  bytes as JAX's ``to_tf_checkpoint(params_to_jax(sd))``; the object graph has
  the nodes, children and attributes of the one TensorFlow writes; a
  ``tf.train.Checkpoint`` skeleton of zeros reads it with ``assert_consumed()``, as it reads
  JAX's export.
- Codec: every supported dtype both ways against TensorFlow, bfloat16 widened
  exactly; one flipped byte in the index or the data raises a crc error; an
  unsupported bundle raises with what it found.
- Remote: ``walk_files`` / ``copy_tree`` as tests/test_gcs.py holds the JAX
  ones; the remote summary writer uploads on the first flush, not on an
  unchanged one, again after a new scalar; ``run.train`` to a gs:// output
  writes its TensorBoard events there.
"""

import os
import struct

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from speech_recognition_tpu_torch.compat import tensor_bundle  # noqa: E402
from speech_recognition_tpu_torch.compat import tf_checkpoint as port_tc  # noqa: E402
from speech_recognition_tpu_torch.weights import params_from_jax, params_to_jax  # noqa: E402

from .const import SP_MODEL_LIBRI, TEST_DATA_DIR, TEST_DS_CONFIG, TEST_LAS_CONFIG, WAV_DATASET_PATH  # noqa: E402
from .test_gcs import FakeGCSHandler, fake_gcs  # noqa: E402,F401  (fixture)
from .test_torch_twins import no_registered_mesh  # noqa: E402,F401  (autouse fixture)

MINI_DATA = f"{TEST_DATA_DIR}/mini_data_config.yml"
CONFIGS = {"las": TEST_LAS_CONFIG, "ds2": TEST_DS_CONFIG}
EXACT = dict(rtol=0, atol=0)


def _jax_variables(config, seed):
    """(JAX model, seeded variables as numpy): the port model's initialization from
    ``seed`` through ``params_to_jax``, biases and batch statistics perturbed, held
    to the tree and shapes of JAX's own ``init`` (traced, not run)."""
    from speech_recognition_tpu.configs import DataConfig, get_model_config
    from speech_recognition_tpu.models import LAS
    from speech_recognition_tpu.run.common import create_model

    model_config = get_model_config(config)
    model = create_model(model_config, jnp.float32)
    data_config = DataConfig.from_yaml(MINI_DATA)
    audio = jnp.zeros((1, 64, data_config.frequency_dim, data_config.feature_dim))
    inputs = (audio, jnp.zeros((1, 8), jnp.int32)) if isinstance(model, LAS) else audio
    template = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)}, inputs))
    variables = params_to_jax(_port_model(config, torch.Generator().manual_seed(seed)).state_dict())
    rng = np.random.default_rng(seed)

    def perturb(tree):
        for name, value in tree.items():
            if isinstance(value, dict):
                perturb(value)
            elif name in ("bias", "mean"):
                tree[name] = value + rng.normal(0.0, 0.1, value.shape).astype(np.float32)
            elif name == "var":
                tree[name] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)

    perturb(variables)
    want = {k: template[k] for k in ("params", "batch_stats") if k in template}
    assert jax.tree_util.tree_structure(variables) == jax.tree_util.tree_structure(want)
    assert [v.shape for v in jax.tree_util.tree_leaves(variables)] == [v.shape for v in jax.tree_util.tree_leaves(want)]
    return model, variables


def _port_model(config, generator=None):
    from speech_recognition_tpu_torch.configs import DataConfig, get_model_config
    from speech_recognition_tpu_torch.run.common import create_model

    return create_model(get_model_config(config), DataConfig.from_yaml(MINI_DATA), torch.float32, torch.device("cpu"),
                        generator=generator)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def reference(request, tmp_path_factory):
    """(name, JAX model, variables, prefix written by JAX's save_tf_checkpoint in a directory with a state file)."""
    from speech_recognition_tpu.compat import save_tf_checkpoint

    model, variables = _jax_variables(CONFIGS[request.param], seed=len(request.param))
    directory = tmp_path_factory.mktemp(request.param)
    prefix = save_tf_checkpoint(variables, str(directory / "ckpt"))
    tf.compat.v1.train.update_checkpoint_state(str(directory), prefix)
    return request.param, model, variables, prefix


def _assert_same_tree(got, want):
    flat_got, tree_got = jax.tree_util.tree_flatten(got)
    flat_want, tree_want = jax.tree_util.tree_flatten(want)
    assert tree_got == tree_want
    for a, b in zip(flat_got, flat_want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_reader_matches_tensorflow_and_jax(reference):
    from speech_recognition_tpu.compat import convert_tf_checkpoint

    _, _, variables, prefix = reference
    want = convert_tf_checkpoint(prefix)
    _assert_same_tree(port_tc.convert_tf_checkpoint(prefix), want)
    _assert_same_tree(port_tc.convert_tf_checkpoint(os.path.dirname(prefix)), want)
    _assert_same_tree(want, variables)
    reader = tf.train.load_checkpoint(prefix)
    keys = tensor_bundle.bundle_keys(os.path.dirname(prefix))
    assert keys == {k: (reader.get_variable_to_dtype_map()[k].name, tuple(s))
                    for k, s in reader.get_variable_to_shape_map().items()}


def test_load_tf_checkpoint_matches_the_jax_model(reference):
    name, model, variables, prefix = reference
    port = port_tc.load_tf_checkpoint(prefix, _port_model(CONFIGS[name]))
    want = params_from_jax(variables)
    state = port.state_dict()
    assert set(state) == set(want)
    for key, value in want.items():
        torch.testing.assert_close(state[key], value, **EXACT, msg=key)

    rng = np.random.default_rng(7)
    audio = rng.uniform(0.0, 5.0, (3, 48, 40, 3)).astype(np.float32)
    audio[1, 30:] = 0.0
    with torch.no_grad():
        if name == "las":
            tokens = rng.integers(1, 16000, (3, 6)).astype(np.int32)
            got = port((torch.from_numpy(audio), torch.from_numpy(tokens).long()), training=False)
            want = jax.jit(lambda v, x: model.apply(v, x, training=False))(variables, (audio, tokens))
            tol = dict(rtol=1e-4, atol=1e-5)
        else:
            got = port(torch.from_numpy(audio))
            want = jax.jit(model.apply)(variables, audio)
            tol = dict(rtol=0, atol=1e-5)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_export_is_read_by_tensorflow_as_jax_writes_it(reference, tmp_path):
    from speech_recognition_tpu.compat import to_tf_checkpoint
    from tensorflow.core.protobuf import trackable_object_graph_pb2

    name, _, variables, reference_prefix = reference
    port = _port_model(CONFIGS[name])
    port.load_state_dict(params_from_jax(variables))
    prefix = port_tc.export_tf_checkpoint(port, str(tmp_path / "export" / "ckpt"))
    want = {k + port_tc._SUFFIX: v for k, v in to_tf_checkpoint(params_to_jax(port.state_dict())).items()}
    reader = tf.train.load_checkpoint(prefix)
    dtypes = reader.get_variable_to_dtype_map()
    assert set(dtypes) == set(want) | {tensor_bundle.OBJECT_GRAPH_KEY}
    for key, value in want.items():
        got = reader.get_tensor(key)
        assert dtypes[key] == tf.float32 and got.dtype == value.dtype and got.shape == value.shape, key
        assert got.tobytes() == value.tobytes(), key

    def graph(path):
        """{node path: (child names, (attribute name, checkpoint key) pairs)}: TensorFlow numbers
        nodes breadth first in the order the attributes were set, the port in name order."""
        proto = trackable_object_graph_pb2.TrackableObjectGraph()
        proto.ParseFromString(tf.train.load_checkpoint(path).get_tensor(tensor_bundle.OBJECT_GRAPH_KEY))
        out, queue = {}, [("", 0)]
        while queue:
            node_path, node_id = queue.pop()
            node = proto.nodes[node_id]
            assert node.has_checkpoint_values.value
            out[node_path] = (sorted(c.local_name for c in node.children),
                              [(a.name, a.checkpoint_key) for a in node.attributes])
            queue += [(f"{node_path}/{c.local_name}", c.node_id) for c in node.children]
        assert len(out) == len(proto.nodes)
        return out

    assert graph(prefix) == graph(reference_prefix)


def _skeleton(keys):
    """A ``tf.train.Checkpoint`` tree at the attribute paths of ``keys`` with zero
    ``tf.Variable`` leaves, built as JAX's ``save_tf_checkpoint`` builds its tree."""
    root, leaves = tf.train.Checkpoint(), {}

    def child(node, part, next_is_index):
        if part.isdigit():
            while len(node) <= int(part):
                node.append([] if next_is_index else tf.train.Checkpoint())
            return node[int(part)]
        if getattr(node, part, None) is None:
            setattr(node, part, [] if next_is_index else tf.train.Checkpoint())
        return getattr(node, part)

    for key, (dtype, shape) in keys.items():
        parts = key.split("/")
        node = root
        for i, part in enumerate(parts[:-1]):
            node = child(node, part, parts[i + 1].isdigit())
        leaves[key] = tf.Variable(tf.zeros(shape, dtype))
        setattr(node, parts[-1], leaves[key])
    return root, leaves


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_skeleton_checkpoint_restores_the_export(reference, tmp_path, writer):
    """``read``, the restore that matches ``write``: ``restore`` would also want the
    ``save_counter`` that only ``save`` writes, from TensorFlow's own ``write`` too."""
    _, _, variables, reference_prefix = reference
    prefix = port_tc.save_tf_checkpoint(variables, str(tmp_path / "ckpt")) if writer == "port" else reference_prefix
    tensors = port_tc.to_tf_checkpoint(variables)
    root, leaves = _skeleton({k: (v.dtype, v.shape) for k, v in tensors.items()})
    root.read(prefix).assert_consumed()
    for key, value in tensors.items():
        np.testing.assert_array_equal(leaves[key].numpy(), value, err_msg=key)
    _assert_same_tree(port_tc.convert_tf_checkpoint(prefix), variables)


def _all_dtypes():
    rng = np.random.default_rng(3)
    return {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "f64": rng.normal(size=(4,)),
        "i32": rng.integers(-2**31, 2**31 - 1, (2, 2, 3), dtype=np.int32),
        "i64": rng.integers(-2**62, 2**62, (7,), dtype=np.int64),
        "bool": rng.uniform(size=(5,)) > 0.5,
        "f16": rng.normal(size=(2, 3)).astype(np.float16),
        "scalar": np.float32(2.5),
        "empty": np.zeros((0, 4), np.float32),
        "strings": np.array([b"", b"a", b"\x00\xff" * 70, "ü".encode()], dtype=object),
    }


def test_every_dtype_round_trips_and_matches_tensorflow(tmp_path):
    tensors = _all_dtypes()
    graph = tensor_bundle.object_graph(tensors, suffix="")
    prefix = tensor_bundle.write_bundle(str(tmp_path / "port" / "ckpt"), tensors, graph)
    back = tensor_bundle.read_bundle(prefix)
    assert back.pop(tensor_bundle.OBJECT_GRAPH_KEY).item() == graph
    reader = tf.train.load_checkpoint(prefix)
    for key, value in tensors.items():
        assert back[key].dtype == value.dtype and back[key].shape == np.shape(value), key
        np.testing.assert_array_equal(back[key], value)
        np.testing.assert_array_equal(reader.get_tensor(key), value)

    # TensorFlow's own writer, bfloat16 included: read back exactly (bfloat16 as float32)
    root, variables = tf.train.Checkpoint(), {}
    for key, value in tensors.items():
        variables[key] = tf.Variable(value)
        setattr(root, key, variables[key])
    root.bf16 = tf.Variable(tf.constant(np.random.default_rng(4).normal(size=(6,)), tf.bfloat16))
    tf_prefix = root.write(str(tmp_path / "tf" / "ckpt"))
    back = tensor_bundle.read_bundle(tf_prefix)
    for key, value in tensors.items():
        np.testing.assert_array_equal(back[key + port_tc._SUFFIX], value)
    bf16 = back["bf16" + port_tc._SUFFIX]
    assert bf16.dtype == np.float32
    np.testing.assert_array_equal(bf16, tf.cast(root.bf16, tf.float32).numpy())
    assert tensor_bundle.bundle_keys(tf_prefix)["bf16" + port_tc._SUFFIX] == ("bfloat16", (6,))


def test_many_keys_span_blocks_and_restarts(tmp_path):
    """Past 256 KiB of index entries the table has several data blocks, each with restarts every 16 entries."""
    tensors = {f"layer{i:05d}/" + "k" * 200: np.full((1,), i, np.int32) for i in range(1500)}
    prefix = tensor_bundle.write_bundle(str(tmp_path / "ckpt"), tensors, tensor_bundle.object_graph(tensors, ""))
    reader = tf.train.load_checkpoint(prefix)
    assert len(reader.get_variable_to_shape_map()) == len(tensors) + 1
    for key in list(tensors)[::97]:
        assert reader.get_tensor(key).tolist() == tensors[key].tolist()
    back = tensor_bundle.read_bundle(prefix, tensors)
    assert all(back[k].tolist() == v.tolist() for k, v in tensors.items())
    tb, raw = tensor_bundle, open(prefix + ".index", "rb").read()
    _, i = tb._read_varint(raw, len(raw) - tb._FOOTER)
    _, i = tb._read_varint(raw, i)
    offset, i = tb._read_varint(raw, i)
    size, _ = tb._read_varint(raw, i)
    assert len(list(tb._entries(tb._block(raw, offset, size, "index"), "index"))) == 2  # data blocks


@pytest.mark.parametrize("part", ["index", "data"])
def test_a_flipped_byte_raises_a_crc_error(tmp_path, part):
    tensors = _all_dtypes()
    prefix = tensor_bundle.write_bundle(str(tmp_path / "ckpt"), tensors, tensor_bundle.object_graph(tensors, ""))
    path = prefix + (".index" if part == "index" else ".data-00000-of-00001")
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 3] ^= 0x10  # inside the first data block of the index, inside a tensor of the data
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="crc32c mismatch"):
        tensor_bundle.read_bundle(prefix)


def _table(entries, kind=0) -> bytes:
    """A one-data-block table written apart from the port's writer, its data block of compression type ``kind``."""
    tb, out = tensor_bundle, bytearray()

    def put(contents, kind=0):
        handle = tb._varint(len(out)) + tb._varint(len(contents))
        out.extend(contents + bytes([kind]) + struct.pack("<I", tb._masked_crc(contents + bytes([kind]))))
        return handle

    data = put(tb._block_bytes(entries, 16), kind)
    handles = put(tb._block_bytes([], 1)) + put(tb._block_bytes([(entries[-1][0], data)], 1))
    return bytes(out) + handles.ljust(40, b"\x00") + struct.pack("<Q", tb._MAGIC)


@pytest.mark.parametrize("case, match", [
    ("magic", "table magic"),
    ("compressed", "compression type 1"),
    ("big_endian", "big-endian"),
    ("slices", "partitioned variable"),
    ("dtype", "dtype code 6"),
    ("missing", "no checkpoint at"),
])
def test_unsupported_bundles_raise(tmp_path, case, match):
    f = tensor_bundle._field
    prefix = str(tmp_path / "ckpt")
    header = f(1, 1)
    entry = f(1, 1) + f(5, 4)
    if case == "big_endian":
        header += f(2, 1)
    elif case == "slices":
        entry += f(7, b"")
    elif case == "dtype":
        entry = f(1, 6) + f(5, 1)
    table = _table([(b"", header), (b"x", entry)], kind=1 if case == "compressed" else 0)
    if case == "magic":
        table = table[:-1] + b"\x00"
    if case != "missing":
        open(prefix + ".index", "wb").write(table)
        open(prefix + ".data-00000-of-00001", "wb").write(b"\x00" * 4)
    with pytest.raises((ValueError, FileNotFoundError), match=match):
        tensor_bundle.read_bundle(prefix)


# ------------------------------------------------------------------ remote storage
def test_walk_files_and_copy_tree(fake_gcs, tmp_path):  # noqa: F811
    from speech_recognition_tpu_torch.utils import gcs, io

    src = tmp_path / "tree"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_text("A")
    (src / "sub" / "b.txt").write_text("B")
    io.copy_tree(str(src), "gs://bkt/up/tree")
    assert io.walk_files("gs://bkt/up/tree") == ["gs://bkt/up/tree/a.txt", "gs://bkt/up/tree/sub/b.txt"]
    assert io.walk_files(str(src)) == [str(src / "a.txt"), str(src / "sub" / "b.txt")]
    dst = tmp_path / "down"
    io.copy_tree("gs://bkt/up/tree", str(dst))
    assert (dst / "a.txt").read_text() == "A"
    assert (dst / "sub" / "b.txt").read_text() == "B"
    gcs.makedirs("gs://bkt/up/tree/empty")
    assert "gs://bkt/up/tree/empty/" not in io.walk_files("gs://bkt/up/tree")


def test_remote_summary_writer_uploads_what_changed(fake_gcs):  # noqa: F811
    from speech_recognition_tpu_torch.run.train import _summary_writer
    from speech_recognition_tpu_torch.utils import get_logger

    writer = _summary_writer("gs://bkt/run/logs", get_logger("test"))
    writer.add_scalar("train/loss", 1.5, 1)
    writer.flush()
    (event,) = [k for k in fake_gcs if k[1].startswith("run/logs/events.out.tfevents")]
    first, stamp = fake_gcs[event], FakeGCSHandler.updated[event]
    writer.flush()
    assert FakeGCSHandler.updated[event] == stamp  # nothing changed: no upload
    writer.add_scalar("train/loss", 0.5, 2)
    writer.flush()
    assert FakeGCSHandler.updated[event] != stamp and len(fake_gcs[event]) > len(first)
    local = os.path.dirname(next(iter(writer._uploaded)))
    writer.close()
    assert not os.path.exists(local)
    tags = [v.tag for e in tf.compat.v1.train.summary_iterator(_local_copy(fake_gcs[event], local + ".ev"))
            for v in e.summary.value]
    assert tags == ["train/loss", "train/loss"]
    os.remove(local + ".ev")


def _local_copy(data: bytes, path: str) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return path


def test_train_writes_tensorboard_events_to_gcs(fake_gcs, tmp_path):  # noqa: F811
    from speech_recognition_tpu_torch.configs import TrainConfig
    from speech_recognition_tpu_torch.run import train

    records = train.main(TrainConfig(
        data_config=MINI_DATA, model_config=TEST_LAS_CONFIG, sp_model_path=SP_MODEL_LIBRI,
        train_dataset_paths=WAV_DATASET_PATH, dev_dataset_paths=WAV_DATASET_PATH, train_dataset_size=2,
        output_path="gs://bkt/run", epochs=1, steps_per_epoch=2, learning_rate=1e-3, batch_size=2, dev_batch_size=2,
        shuffle_buffer_size=1, max_over_policy="slice", device="CPU", seed=1))
    assert records[0]["checkpoint"].startswith("gs://bkt/run/models/")
    (event,) = [name for (_, name) in fake_gcs if name.startswith("run/logs/events.out.tfevents")]
    path = _local_copy(fake_gcs[("bkt", event)], str(tmp_path / "events"))
    tags = [v.tag for e in tf.compat.v1.train.summary_iterator(path) for v in e.summary.value]
    assert tags.count("train/loss") == 2 and "val/val_loss" in tags


def test_cli_defaults_convert_beside_the_checkpoint(reference, tmp_path):
    """``--checkpoint`` alone: the data config from two levels up, the ``.pt`` beside the checkpoint;
    ``--export`` needs ``--output``."""
    import shutil

    name, _, variables, prefix = reference
    models = tmp_path / "out" / "models"
    models.mkdir(parents=True)
    shutil.copy(MINI_DATA, tmp_path / "out" / "data-config.yml")
    for f in os.listdir(os.path.dirname(prefix)):
        if f.startswith("ckpt."):
            shutil.copy(os.path.join(os.path.dirname(prefix), f), models / f)
    pt = port_tc.main(["--checkpoint", str(models / "ckpt"), "--model-config", CONFIGS[name]])
    assert pt == str(models / "ckpt") + ".pt"
    state = torch.load(pt, weights_only=True)
    for key, value in params_from_jax(variables).items():
        torch.testing.assert_close(state[key], value, **EXACT, msg=key)
    with pytest.raises(SystemExit):
        port_tc.main(["--export", pt, "--model-config", CONFIGS[name]])
