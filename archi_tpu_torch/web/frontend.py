"""Chat frontend: a single-file SPA served by the chat service.

Copy of ``archi_tpu/web/frontend.py``.

The reference ships a ~10.3k-line vanilla-JS SPA
(``src/interfaces/chat_app/static/chat.js`` + ``modules/*``).  This is a
compact vanilla-JS equivalent covering the same workflows: streaming chat
with live agent-step/tool events (SSE), conversation list + history, source
chips, feedback, trace panel, **A/B model comparison with preference
voting** (``modules/ab-testing.js`` analog), a **data tab** with upload,
URL-scrape, git-repo and schedule management plus per-conversation document
selection, an **admin tab** with the read-only DB console
(``modules/db-admin.js`` analog) and usage analytics, and **session login**
against ``/api/auth/*``.

The browser-free test tier (``tests/unit/test_frontend_contract.py``)
asserts this file's API calls against the live router — every route the JS
touches must exist and answer.
"""

FRONTEND_HTML = r"""<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>archi-tpu</title>
<style>
:root{--bg:#0f1115;--panel:#171a21;--border:#262b36;--text:#e6e9ef;
--dim:#8b93a7;--accent:#4f8cff;--user:#1d2634;--bot:#171f2b}
*{box-sizing:border-box;margin:0}
body{background:var(--bg);color:var(--text);font:14px/1.5 system-ui,sans-serif;
display:grid;grid-template-columns:260px 1fr 320px;height:100vh}
aside,main,#tracePanel{overflow-y:auto}
aside{background:var(--panel);border-right:1px solid var(--border);padding:12px}
aside h1{font-size:15px;margin-bottom:12px;color:var(--accent)}
#convList button{display:block;width:100%;text-align:left;background:none;
border:none;color:var(--text);padding:8px;border-radius:6px;cursor:pointer;
overflow:hidden;white-space:nowrap;text-overflow:ellipsis}
#convList button:hover,#convList button.active{background:var(--user)}
#newConv{width:100%;margin-bottom:8px;background:var(--accent);border:none;
color:#fff;padding:8px;border-radius:6px;cursor:pointer}
main{display:flex;flex-direction:column}
#messages{flex:1;padding:20px;overflow-y:auto}
.msg{max-width:80%;margin-bottom:12px;padding:10px 14px;border-radius:10px;
white-space:pre-wrap;word-break:break-word}
.msg.user{background:var(--user);margin-left:auto}
.msg.bot{background:var(--bot);border:1px solid var(--border)}
.sources{margin-top:6px}
.chip{display:inline-block;background:#223049;border-radius:10px;
padding:2px 8px;margin:2px;font-size:12px;color:var(--dim)}
.fb button{background:none;border:none;cursor:pointer;color:var(--dim)}
#composer{display:flex;gap:8px;padding:12px;border-top:1px solid var(--border)}
#input{flex:1;background:var(--panel);border:1px solid var(--border);
color:var(--text);border-radius:8px;padding:10px;resize:none}
#send{background:var(--accent);border:none;color:#fff;padding:0 18px;
border-radius:8px;cursor:pointer}
#tracePanel{background:var(--panel);border-left:1px solid var(--border);
padding:12px;font-size:12px}
#tracePanel h2{font-size:13px;margin-bottom:8px;color:var(--dim)}
.ev{border-left:2px solid var(--border);padding:4px 8px;margin-bottom:6px;
color:var(--dim)}
.ev.tool_start{border-color:#e3b341}.ev.tool_result{border-color:#3fb950}
.ev.agent_step{border-color:var(--accent)}
.ev b{color:var(--text)}
#status{color:var(--dim);font-size:12px;padding:0 20px}
.tab{flex:1;background:var(--panel);border:1px solid var(--border);
color:var(--dim);padding:6px;border-radius:6px;cursor:pointer;font-size:12px}
.tab.active{color:var(--text);border-color:var(--accent)}
#dataView,#adminView{display:none;flex:1;padding:20px;overflow-y:auto}
#dataView h2,#adminView h2{font-size:14px;margin:12px 0 6px;color:var(--dim)}
.docrow{display:flex;align-items:center;gap:8px;padding:6px;
border-bottom:1px solid var(--border);font-size:13px}
.docrow .nm{flex:1;overflow:hidden;text-overflow:ellipsis;white-space:nowrap}
.docrow .st{color:var(--dim);font-size:11px}
.box{margin-top:14px;padding:12px;border:1px dashed var(--border);
border-radius:8px;color:var(--dim)}
.box input[type=text],.box input[type=password]{background:var(--bg);
border:1px solid var(--border);color:var(--text);border-radius:6px;
padding:6px;margin-right:6px;width:50%}
.box button,.ab-vote button{background:var(--accent);border:none;color:#fff;
padding:6px 12px;border-radius:6px;cursor:pointer;margin:2px}
#abBar{display:none;gap:8px;padding:6px 12px;border-top:1px solid var(--border);
font-size:12px;align-items:center}
#abBar select{background:var(--panel);color:var(--text);
border:1px solid var(--border);border-radius:6px;padding:4px}
.ab-pair{display:flex;gap:10px;margin-bottom:12px}
.ab-col{flex:1;background:var(--bot);border:1px solid var(--border);
border-radius:10px;padding:10px;white-space:pre-wrap}
.ab-col h3{font-size:12px;color:var(--dim);margin-bottom:6px}
#sqlBox{width:100%;height:70px;background:var(--bg);color:var(--text);
border:1px solid var(--border);border-radius:6px;padding:8px;
font-family:monospace}
#sqlResult{overflow-x:auto;margin-top:8px}
#sqlResult table{border-collapse:collapse;font-size:12px}
#sqlResult td,#sqlResult th{border:1px solid var(--border);padding:4px 8px}
#loginBox{margin-top:14px;font-size:12px;color:var(--dim)}
#loginBox input{width:100%;margin-bottom:4px;background:var(--bg);
border:1px solid var(--border);color:var(--text);border-radius:6px;padding:6px}
#loginBox button{width:100%;background:var(--accent);border:none;color:#fff;
padding:6px;border-radius:6px;cursor:pointer}
</style>
</head>
<body>
<aside>
  <h1>archi-tpu</h1>
  <div style="display:flex;gap:6px;margin-bottom:10px">
    <button class="tab active" data-tab="chat">Chat</button>
    <button class="tab" data-tab="data">Data</button>
    <button class="tab" data-tab="admin">Admin</button>
  </div>
  <button id="newConv">+ New conversation</button>
  <div id="convList"></div>
  <div id="loginBox">
    <div id="whoami"></div>
    <input type="text" id="loginEmail" placeholder="email">
    <input type="password" id="loginPw" placeholder="password">
    <button id="loginBtn">Sign in</button>
  </div>
</aside>
<main>
  <div id="dataView">
    <div id="ingestStatus" class="st"></div>
    <div id="docGroups"></div>
    <div class="box">
      Upload a document: <input type="file" id="fileInput">
      <span id="uploadMsg"></span>
    </div>
    <div class="box">
      Scrape a URL: <input type="text" id="linkUrl" placeholder="https://…">
      <button id="linkAdd">Scrape</button> <span id="linkMsg"></span>
    </div>
    <div class="box">
      Add git repo: <input type="text" id="gitUrl" placeholder="https://…/repo.git">
      <button id="gitAdd">Clone + ingest</button> <span id="gitMsg"></span>
    </div>
    <div class="box">
      <h2>Ingestion schedules (cron per source)</h2>
      <div id="schedList"></div>
      <input type="text" id="schedName" placeholder="source name">
      <input type="text" id="schedCron" placeholder="*/30 * * * *">
      <button id="schedSave">Save schedule</button> <span id="schedMsg"></span>
      <div><button id="retryFailed">Retry failed documents</button></div>
    </div>
  </div>
  <div id="adminView">
    <h2>Read-only DB console (single SELECT)</h2>
    <textarea id="sqlBox">SELECT id, email, roles FROM users LIMIT 20</textarea>
    <button id="sqlRun" class="tab">Run</button>
    <div id="sqlResult"></div>
    <h2>Analytics</h2>
    <div id="analytics" class="st"></div>
  </div>
  <div id="messages"></div>
  <div id="status"></div>
  <div id="abBar">
    A/B compare: <select id="modelA"></select> vs <select id="modelB"></select>
    <span class="st">next message runs both models</span>
  </div>
  <div id="composer">
    <textarea id="input" rows="2" placeholder="Ask a question…"></textarea>
    <button id="abToggle" class="tab" title="A/B compare">A/B</button>
    <button id="send">Send</button>
  </div>
</main>
<div id="tracePanel"><h2>Agent trace</h2><div id="events"></div></div>
<script>
let conversationId=null,busy=false,abMode=false;
const $=s=>document.querySelector(s);
const esc=t=>{const d=document.createElement('div');d.textContent=t;return d.innerHTML};

async function api(path,opts={}){
  const r=await fetch(path,{headers:{'Content-Type':'application/json'},...opts});
  if(!r.ok)throw new Error((await r.json()).error||r.status);
  return r.json();
}
function addMsg(sender,text,extra){
  const div=document.createElement('div');
  div.className='msg '+(sender==='User'?'user':'bot');
  div.innerHTML=esc(text);
  if(extra&&extra.sources&&extra.sources.length){
    const s=document.createElement('div');s.className='sources';
    for(const src of extra.sources){
      const c=document.createElement('span');c.className='chip';
      c.textContent=(src.display_name||src.url||'source')+' ('+(src.score??0).toFixed(2)+')';
      if(src.url){c.style.cursor='pointer';c.onclick=()=>window.open(src.url)}
      s.appendChild(c);
    }
    div.appendChild(s);
  }
  if(extra&&extra.message_id){
    const fb=document.createElement('div');fb.className='fb';
    for(const r of['like','dislike']){
      const b=document.createElement('button');b.textContent=r==='like'?'👍':'👎';
      b.onclick=()=>api('/api/feedback',{method:'POST',body:JSON.stringify(
        {message_id:extra.message_id,rating:r})}).then(()=>b.style.color='#4f8cff');
      fb.appendChild(b);
    }
    div.appendChild(fb);
  }
  $('#messages').appendChild(div);
  $('#messages').scrollTop=1e9;
  return div;
}
function addEvent(ev){
  const d=document.createElement('div');d.className='ev '+(ev.type||'');
  let txt='<b>'+esc(ev.type||'event')+'</b> ';
  if(ev.name)txt+=esc(ev.name)+' ';
  if(ev.args)txt+=esc(JSON.stringify(ev.args).slice(0,120));
  if(ev.result)txt+=esc(String(ev.result).slice(0,160));
  if(ev.content)txt+=esc(String(ev.content).slice(0,160));
  d.innerHTML=txt;
  $('#events').appendChild(d);
  $('#tracePanel').scrollTop=1e9;
}
async function loadConversations(){
  try{
    const convs=await api('/api/conversations');
    const list=$('#convList');list.innerHTML='';
    for(const c of convs){
      const b=document.createElement('button');
      b.textContent=c.title||('conversation '+c.id);
      if(c.id===conversationId)b.className='active';
      b.onclick=()=>openConversation(c.id);
      list.appendChild(b);
    }
  }catch(e){}
}
async function openConversation(id){
  conversationId=id;$('#messages').innerHTML='';$('#events').innerHTML='';
  const msgs=await api('/api/conversations/'+id);
  for(const m of msgs)addMsg(m.sender,m.content,
    {sources:(m.metadata||{}).sources,message_id:m.sender!=='User'?m.id:null});
  loadConversations();
}
async function send(){
  if(busy)return;
  const text=$('#input').value.trim();
  if(!text)return;
  $('#input').value='';busy=true;$('#status').textContent='thinking…';
  addMsg('User',text);
  $('#events').innerHTML='';
  try{
    if(abMode){await sendAB(text);}
    else{await sendStream(text);}
  }catch(e){addMsg('archi','Error: '+e.message)}
  busy=false;if($('#status').textContent==='thinking…')$('#status').textContent='';
  loadConversations();
}
async function sendStream(text){
  const resp=await fetch('/api/get_chat_response_stream',{method:'POST',
    headers:{'Content-Type':'application/json'},
    body:JSON.stringify({message:text,conversation_id:conversationId,
                         client_sent:Date.now()/1000})});
  const reader=resp.body.getReader();const dec=new TextDecoder();
  let buf='';
  for(;;){
    const {done,value}=await reader.read();
    if(done)break;
    buf+=dec.decode(value,{stream:true});
    let i;
    while((i=buf.indexOf('\n\n'))>=0){
      const frame=buf.slice(0,i);buf=buf.slice(i+2);
      if(!frame.startsWith('data: '))continue;
      const data=frame.slice(6);
      if(data==='[DONE]')continue;
      const ev=JSON.parse(data);
      if(ev.type==='token'){
        if(!window._pending){window._pending=addMsg('archi','')}
        window._pending.innerHTML+=esc(ev.delta||'');
        $('#messages').scrollTop=1e9;
      }else if(ev.type==='final'){
        conversationId=ev.conversation_id;
        if(window._pending){window._pending.remove();window._pending=null}
        addMsg('archi',ev.answer,{sources:ev.sources,message_id:ev.message_id});
        $('#status').textContent='model: '+((ev.metadata||{}).model_used||'')+
          '  ·  '+(ev.timing&&ev.timing.msg_duration?ev.timing.msg_duration.toFixed(2)+'s':'');
      }else if(ev.type==='trace_start'){conversationId=ev.conversation_id;}
      else addEvent(ev);
    }
  }
}
// ------------------------------------------------------------- A/B compare
async function sendAB(text){
  const out=await api('/api/ab_compare',{method:'POST',body:JSON.stringify({
    message:text,model_a:$('#modelA').value,model_b:$('#modelB').value,
    conversation_id:conversationId})});
  conversationId=out.conversation_id||conversationId;
  const pair=document.createElement('div');pair.className='ab-pair';
  for(const side of['a','b']){
    const col=document.createElement('div');col.className='ab-col';
    col.innerHTML='<h3>'+esc(out['model_'+side]||side.toUpperCase())+'</h3>'+
      esc(out['answer_'+side]||'');
    pair.appendChild(col);
  }
  const vote=document.createElement('div');vote.className='ab-vote';
  for(const [label,pref] of [['A is better','a'],['B is better','b'],['Tie','tie']]){
    const b=document.createElement('button');b.textContent=label;
    b.onclick=()=>api('/api/ab_preference',{method:'POST',body:JSON.stringify(
      {comparison_id:out.comparison_id,preference:pref})})
      .then(()=>{vote.innerHTML='<span class="st">recorded ✓</span>'});
    vote.appendChild(b);
  }
  pair.appendChild(vote);
  $('#messages').appendChild(pair);
  $('#messages').scrollTop=1e9;
}
async function loadModels(){
  try{
    const provs=await api('/api/providers');
    for(const sel of[$('#modelA'),$('#modelB')]){
      sel.innerHTML='';
      for(const p of provs){
        if(!p.enabled&&!p.configured)continue;
        for(const m of p.models||[]){
          const o=document.createElement('option');
          o.value=p.provider_type+'/'+m.name;o.textContent=p.provider_type+'/'+m.name;
          sel.appendChild(o);
        }
      }
    }
  }catch(e){}
}
$('#abToggle').onclick=()=>{
  abMode=!abMode;
  $('#abToggle').classList.toggle('active',abMode);
  $('#abBar').style.display=abMode?'flex':'none';
  if(abMode)loadModels();
};
$('#send').onclick=send;
$('#input').addEventListener('keydown',e=>{
  if(e.key==='Enter'&&!e.shiftKey){e.preventDefault();send()}});
$('#newConv').onclick=()=>{conversationId=null;$('#messages').innerHTML='';
  $('#events').innerHTML='';loadConversations()};

// ------------------------------------------------------------------- login
async function loadSession(){
  try{
    const s=await api('/api/auth/session');
    if(s.email){
      $('#whoami').innerHTML=esc(s.email)+' · <a href="#" id="logout">sign out</a>';
      $('#loginEmail').style.display='none';$('#loginPw').style.display='none';
      $('#loginBtn').style.display='none';
      $('#logout').onclick=async e=>{e.preventDefault();
        await api('/api/auth/logout',{method:'POST'});location.reload()};
    }
  }catch(e){}
}
$('#loginBtn').onclick=async()=>{
  try{
    await api('/api/auth/login',{method:'POST',body:JSON.stringify(
      {email:$('#loginEmail').value,password:$('#loginPw').value})});
    location.reload();
  }catch(e){$('#whoami').textContent='login failed: '+e.message}
};

// ---------------------------------------------------------------- data tab
async function loadData(){
  try{
    const st=await api('/api/dm/status');
    $('#ingestStatus').textContent='ingestion: '+(st.status||'?')+
      '  ·  '+JSON.stringify(st.by_status||{});
  }catch(e){$('#ingestStatus').textContent='data manager unreachable'}
  let enabled=null;
  if(conversationId){
    try{enabled=await api('/api/conversations/'+conversationId+'/documents')}
    catch(e){}
  }
  const enabledMap={};
  if(enabled)for(const d of enabled)enabledMap[d.resource_hash]=d.enabled;
  try{
    const groups=await api('/api/dm/grouped');
    const el=$('#docGroups');el.innerHTML='';
    for(const [src,docs] of Object.entries(groups)){
      const h=document.createElement('h2');h.textContent=src;el.appendChild(h);
      for(const d of docs){
        const row=document.createElement('div');row.className='docrow';
        if(conversationId){
          const cb=document.createElement('input');cb.type='checkbox';
          cb.checked=enabledMap[d.resource_hash]!==false;
          cb.onchange=()=>api('/api/conversations/'+conversationId+
            '/documents',{method:'PUT',body:JSON.stringify(
            {[d.resource_hash]:cb.checked})});
          row.appendChild(cb);
        }
        const nm=document.createElement('span');nm.className='nm';
        nm.textContent=d.display_name;row.appendChild(nm);
        const st=document.createElement('span');st.className='st';
        st.textContent=d.ingestion_status||'';row.appendChild(st);
        const del=document.createElement('button');del.textContent='✕';
        del.className='fb';del.style.background='none';del.style.border='none';
        del.style.color='var(--dim)';del.style.cursor='pointer';
        del.onclick=()=>api('/api/dm/documents/'+d.resource_hash,
          {method:'DELETE'}).then(()=>setTimeout(loadData,500));
        row.appendChild(del);
        el.appendChild(row);
      }
    }
  }catch(e){$('#docGroups').textContent='error: '+e.message}
  loadSchedules();
}
async function loadSchedules(){
  try{
    const s=await api('/api/dm/schedules');
    const el=$('#schedList');el.innerHTML='';
    for(const j of (s.jobs||[])){
      const d=document.createElement('div');d.className='st';
      d.textContent=(j.name||j)+' : '+(j.cron||'');
      el.appendChild(d);
    }
  }catch(e){}
}
$('#fileInput').onchange=async e=>{
  const f=e.target.files[0];if(!f)return;
  const buf=await f.arrayBuffer();
  const b64=btoa(String.fromCharCode(...new Uint8Array(buf)));
  $('#uploadMsg').textContent='uploading…';
  try{
    await api('/api/dm/upload',{method:'POST',body:JSON.stringify(
      {filename:f.name,content_b64:b64})});
    $('#uploadMsg').textContent='uploaded ✓ (ingestion triggered)';
    setTimeout(loadData,1500);
  }catch(err){$('#uploadMsg').textContent='failed: '+err.message}
};
$('#linkAdd').onclick=async()=>{
  $('#linkMsg').textContent='scraping…';
  try{
    const r=await api('/api/dm/links',{method:'POST',body:JSON.stringify(
      {url:$('#linkUrl').value})});
    $('#linkMsg').textContent='collected '+r.collected+' pages ✓';
    setTimeout(loadData,1500);
  }catch(e){$('#linkMsg').textContent='failed: '+e.message}
};
$('#gitAdd').onclick=async()=>{
  $('#gitMsg').textContent='cloning…';
  try{
    const r=await api('/api/dm/git',{method:'POST',body:JSON.stringify(
      {url:$('#gitUrl').value})});
    $('#gitMsg').textContent='collected '+r.collected+' files ✓';
    setTimeout(loadData,1500);
  }catch(e){$('#gitMsg').textContent='failed: '+e.message}
};
$('#schedSave').onclick=async()=>{
  try{
    await api('/api/dm/schedules',{method:'PUT',body:JSON.stringify(
      {[$('#schedName').value]:$('#schedCron').value})});
    $('#schedMsg').textContent='saved ✓';loadSchedules();
  }catch(e){$('#schedMsg').textContent='failed: '+e.message}
};
$('#retryFailed').onclick=async()=>{
  try{await api('/api/dm/retry',{method:'POST',body:'{}'});
    setTimeout(loadData,1000);}catch(e){}
};

// --------------------------------------------------------------- admin tab
$('#sqlRun').onclick=async()=>{
  const el=$('#sqlResult');el.textContent='running…';
  try{
    const rows=await api('/api/admin/db',{method:'POST',body:JSON.stringify(
      {sql:$('#sqlBox').value})});
    if(!rows.length){el.textContent='(no rows)';return}
    const cols=Object.keys(rows[0]);
    let html='<table><tr>'+cols.map(c=>'<th>'+esc(c)+'</th>').join('')+'</tr>';
    for(const r of rows)html+='<tr>'+cols.map(c=>'<td>'+esc(String(r[c]??''))+
      '</td>').join('')+'</tr>';
    el.innerHTML=html+'</table>';
  }catch(e){el.textContent='error: '+e.message}
};
async function loadAnalytics(){
  const el=$('#analytics');el.innerHTML='';
  for(const [label,path] of [['models','/api/v2/analytics/models'],
      ['feedback','/api/v2/analytics/feedback'],
      ['A/B','/api/v2/analytics/ab'],
      ['timing','/api/v2/analytics/timing']]){
    try{
      const d=await api(path);
      const div=document.createElement('div');
      div.innerHTML='<b>'+esc(label)+'</b>: '+esc(JSON.stringify(d).slice(0,300));
      el.appendChild(div);
    }catch(e){}
  }
}
// --------------------------------------------------------------------- tabs
for(const b of document.querySelectorAll('.tab[data-tab]')){
  b.onclick=()=>{
    for(const t of document.querySelectorAll('.tab[data-tab]'))
      t.classList.remove('active');
    b.classList.add('active');
    const tab=b.dataset.tab;
    $('#dataView').style.display=tab==='data'?'block':'none';
    $('#adminView').style.display=tab==='admin'?'block':'none';
    $('#messages').style.display=tab==='chat'?'block':'none';
    $('#composer').style.display=tab==='chat'?'flex':'none';
    if(tab==='data')loadData();
    if(tab==='admin')loadAnalytics();
  };
}
loadConversations();
loadSession();
</script>
</body>
</html>
"""
